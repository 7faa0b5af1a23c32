"""Fault tolerance: fault injection and policy (:mod:`.supervisor`), and
shard loss, lineage recovery and repartitioning of engine relations
(:mod:`.elastic`).  DESIGN.md §12–§13."""
