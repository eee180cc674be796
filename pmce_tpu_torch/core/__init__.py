"""Training runtime of the port: config, optimizer, losses, checkpoints,
the train and eval steps of both stages and the epoch loop."""
