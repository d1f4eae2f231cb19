"""The training step: in-step GT preparation, losses, backward, optimizer."""
