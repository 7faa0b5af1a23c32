"""SGF query service: relation catalog, plan/executable cache, cross-query
MSJ batching, and a slot-limited scheduler (DESIGN.md §9).

Dataflow: ``Catalog`` (resident relations + stats, per-relation epochs) →
``SGFService.submit`` (admission queue) → ``fuse_requests`` (canonicalize
+ dedup into one multi-tenant batch) → ``ResultCache`` (warm queries
served by scatter, zero jobs) → ``PlanCache`` (fingerprint-keyed plans
for the cold remainder) → ``SlotScheduler`` (LPT cost estimates feeding
the ready-queue executor's W-slot walk of the job DAG, with per-job
probe-backend dispatch — DESIGN.md §11) → per-request output scatter.
"""
from repro_torch.service.batcher import (
    AdmissionBatcher,
    FusedBatch,
    QuarantinedError,
    QueryRequest,
    RetryPolicy,
    SGFService,
    fuse_requests,
)
from repro_torch.service.catalog import Catalog, CatalogError, catalog_from_numpy, query_deps
from repro_torch.service.plan_cache import PlanCache, canonicalize, fingerprint_queries
from repro_torch.service.result_cache import ResultCache, xmat_content_key
from repro_torch.service.scheduler import SlotScheduler

__all__ = [
    "AdmissionBatcher",
    "Catalog",
    "CatalogError",
    "FusedBatch",
    "PlanCache",
    "QuarantinedError",
    "QueryRequest",
    "RetryPolicy",
    "ResultCache",
    "SGFService",
    "SlotScheduler",
    "canonicalize",
    "catalog_from_numpy",
    "fingerprint_queries",
    "fuse_requests",
    "query_deps",
    "xmat_content_key",
]
