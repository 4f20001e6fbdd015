"""Serving front ends of the port: the row-sharded LTI lane and the recsys
steps (``steps``), the continuous-batching scheduler (``scheduler``) and
the replica router (``replica``)."""
from .replica import ReplicaSet
from .scheduler import BatchScheduler, Clock, Ticket, VirtualClock, WallClock
from .steps import (make_recsys_serve_step, make_retrieval_step,
                    make_sharded_lti_lane, make_sharded_unified_step)

__all__ = ["BatchScheduler", "Clock", "ReplicaSet", "Ticket",
           "VirtualClock", "WallClock", "make_recsys_serve_step",
           "make_retrieval_step", "make_sharded_lti_lane",
           "make_sharded_unified_step"]
