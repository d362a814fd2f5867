"""The port's training path: losses, the train step and the Trainer."""
