"""Training: losses, the 9-group Adam optimizer, densification statistics and
the train step (port of ed3dgs_tpu/train/)."""
