"""The transformer families' serving path (dense, moe, vlm), as torch modules."""
