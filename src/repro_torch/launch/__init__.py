"""Launch entry points of the port: the serving driver (``serve``), the
training driver (``train``) and the freshdiskann-1b shard deployment's
distributed steps (``ann_steps``)."""
