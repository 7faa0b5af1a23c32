"""Data: deterministic synthetic token batches and corpus relations
(:mod:`.synthetic`), and the SGF corpus filter (:mod:`.pipeline`); the
``repro.data`` counterpart."""
