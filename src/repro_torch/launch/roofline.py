"""Three-term roofline over the dry-run's per-rank counts, priced with the
NVIDIA H100 SXM 80 GB's data-sheet rates.

The counterpart of ``repro.launch.roofline``.  Per (arch × shape × mesh):

    compute    = FLOPs      / (ranks × 989 TFLOP/s dense bf16)
    memory     = bytes      / (ranks × 3.35 TB/s HBM3)
    collective = coll_bytes / (ranks × 50 GB/s per link)

All three in seconds; the counts are aggregates (per-rank totals of
:mod:`repro_torch.launch.opcost` × ranks), so the ranks in the denominator
cancel back to per-rank time.  The bottleneck is the largest term;
``roofline_frac`` is ``MODEL_FLOPS`` time over the largest term: the share
of the step's lower bound spent on useful model FLOPs (6·N·D for training,
2·N·D forward-only), an MFU bound from the counts alone.

The link rate is one 400 Gb/s NDR InfiniBand port per GPU.  On 8-GPU
NVLink nodes both 16-wide axes of the production mesh span nodes, so a
ring over either axis runs at the inter-node link's rate, not at NVLink's
450 GB/s per direction.  Like the reference, the model does not split
links by topology: every collective byte is priced at this one rate.
These are counts priced with data-sheet peaks, not times measured on a
card.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.configs.base import ArchConfig, ShapeSpec

PEAK_FLOPS = 989e12  # dense bf16 per GPU (NVIDIA H100 SXM 80 GB data sheet, no sparsity)
HBM_BW = 3.35e12  # bytes/s per GPU (NVIDIA H100 SXM 80 GB data sheet, HBM3)
LINK_BW = 50e9  # bytes/s per GPU: one 400 Gb/s NDR InfiniBand port (ConnectX-7)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # aggregate over ranks
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_counts: dict
    # seconds
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_flop_ratio: float  # MODEL_FLOPS / counted FLOPs
    roofline_frac: float  # MODEL_FLOPS time / dominant term
    step_lower_bound_s: float

    def to_dict(self):
        return asdict(self)


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6·N·D for train (fwd+bwd), 2·N·D forward-only for serving;
    N = active params for MoE."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def build(cfg: ArchConfig, shape: ShapeSpec, mesh_desc: str, chips: int,
          per_chip_flops: float, per_chip_bytes: float,
          per_chip_coll_bytes: float, coll_counts: dict) -> Roofline:
    agg_flops = per_chip_flops * chips
    agg_bytes = per_chip_bytes * chips
    agg_coll = per_chip_coll_bytes * chips
    t_c = agg_flops / (chips * PEAK_FLOPS)
    t_m = agg_bytes / (chips * HBM_BW)
    t_x = agg_coll / (chips * LINK_BW)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    lb = max(terms.values())
    mf = model_flops(cfg, shape)
    t_useful = mf / (chips * PEAK_FLOPS)
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_desc, chips=chips,
        hlo_flops=agg_flops, hlo_bytes=agg_bytes, coll_bytes=agg_coll,
        coll_counts=dict(coll_counts),
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck,
        model_flops=mf,
        useful_flop_ratio=mf / max(agg_flops, 1.0),
        roofline_frac=t_useful / max(lb, 1e-30),
        step_lower_bound_s=lb,
    )
