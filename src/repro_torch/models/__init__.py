"""Model zoo: every family of ``repro.models``, serving and training."""
