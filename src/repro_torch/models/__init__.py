"""The LM scaffold's dense family: layers and the transformer."""
