"""Model code of the port: config mirror, layers, the decoder of every
family (attention, MoE, RWKV-6, hybrid), the frontends and the training
loss."""
