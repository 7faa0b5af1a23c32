"""The reference's ``examples/`` scripts on the port, one module each, on
the card unless ``--device cpu``:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.data_pipeline [--device cpu]
    python -m repro_torch.examples.sgf_service [--device cpu] [--trace PATH]
    python -m repro_torch.examples.serve_lm [--arch ARCH] [--device cpu]
    python -m repro_torch.examples.train_lm [--arch ARCH] [--steps N] [--device cpu]

Each takes its script's flags plus ``--device``; ``main(argv)`` prints
what the script prints and returns its numbers.  The body is plain
functions that take sizes and a device, which ``main`` calls at the
script's constants.
"""
