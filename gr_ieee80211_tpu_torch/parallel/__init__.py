"""Sharded scale-out of the receive programs (``mesh``: one process;
``distributed``: several processes over ``torch.distributed``)."""
