"""Model stacks of the port: the LM transformers, the two-tower recsys
towers and the four GNNs, with their training and serving steps."""
