"""Model code of the port: config mirror, layers and the attention-family
decoder."""
