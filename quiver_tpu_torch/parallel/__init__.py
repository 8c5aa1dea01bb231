"""Sharded engines over a shard list (PyTorch port of
``quiver_tpu/parallel/``): the exact scan (``sharded.py``), IVF
(``sharded_ivf.py``) and HNSW (``sharded_graph.py``) in one process, the
multi-process merge over ``torch.distributed`` (``distributed.py``) and the
pipeline dry run (``dryrun.py``)."""
