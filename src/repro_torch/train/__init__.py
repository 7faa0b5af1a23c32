"""Training: AdamW (:mod:`.optimizer`), error-feedback top-k gradient
compression (:mod:`.grad_compress`) and the train-step factory
(:mod:`.train_step`); the ``repro.train`` counterpart."""
