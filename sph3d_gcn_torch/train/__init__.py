"""Training side: the train and eval steps, the learning-rate schedule
and optimizers, the training loop, checkpoints, augmentation policies,
metrics, profiling and the eval voting protocol."""
