"""Training: DBB-annealed train step, optimizers, gradient compression,
checkpoints and fault tolerance."""
