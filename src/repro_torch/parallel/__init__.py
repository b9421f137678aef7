"""Sharding on ``torch.distributed.tensor``: the logical-axis rules
(``sharding``) and the reference's spec for every leaf (``specs``)."""
