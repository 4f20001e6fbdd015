"""Durable directory commits shared by the storage layout (``store``)."""
