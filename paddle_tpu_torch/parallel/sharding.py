"""Sharding hints on one device (counterpart of
``paddle_tpu/parallel/sharding.py``'s ``constraint``)."""


def constraint(x, *spec):  # noqa: ARG001 - the spec names mesh axes
    """The identity: with one device there is nothing to shard."""
    return x
