"""Several cards: one process per card on ``torch.distributed``, in the
place of the JAX package's device mesh (``launch``, ``mesh``,
``collectives``, ``serve_launch``)."""
