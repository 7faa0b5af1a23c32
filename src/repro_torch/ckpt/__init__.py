"""Checkpoints in the reference's on-disk layout (:mod:`.checkpoint`); the
``repro.ckpt`` counterpart."""
