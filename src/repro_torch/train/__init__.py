"""Training of the port's models: the optimizers (:mod:`.optimizer`), the
train step (:mod:`.train_step`), checkpoints (:mod:`.checkpoint`) and the
elastic policy hooks (:mod:`.elastic`), as the reference's ``train``."""
