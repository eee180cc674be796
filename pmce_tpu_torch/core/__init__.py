"""Training runtime of the port: config, optimizer, losses, checkpoints,
the Stage-1 lifter's train and eval steps and the epoch loop."""
