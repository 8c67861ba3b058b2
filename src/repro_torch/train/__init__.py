"""Training substrate: the trainer loop and checkpointing."""
