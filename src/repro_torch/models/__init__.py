"""Model families of the port.

  recsys.py — EmbeddingBag, FM / DeepFM / xDeepFM (CIN) / SASRec: the
              serving path (forward values), ported with the retrieval
              integration it feeds.

The reference's other families wait for their slices (``ROADMAP.md``,
Queue 1): the decoder LMs (``transformer.py``, ``moe.py``, ``layers.py``)
for LM serving, GraphSAGE (``gnn.py``) after it, and every family's
gradients for the training slice.
"""
