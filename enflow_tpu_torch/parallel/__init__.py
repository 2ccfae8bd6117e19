"""Multi-device support, the port of ``enflow_tpu/parallel``: the collective
interface (``collectives.py``), the mesh and process set-up (``mesh.py``),
the ring pair terms (``pairwise.py``), the ring EGCL (``ring.py``) and a
dry run of every sharded program family (``dryrun.py``)."""
