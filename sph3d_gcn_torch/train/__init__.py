"""Training side: the train and eval steps, the learning-rate schedule
and optimizers, and the eval voting protocol."""
