"""Model stacks of the port: the LM transformers and the two-tower recsys
towers, with their serving steps."""
