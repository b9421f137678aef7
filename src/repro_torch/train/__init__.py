"""Training on one device: optimizers, the train step and the trainer."""
