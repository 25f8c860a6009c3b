"""Several devices or several ranks: the collectives (``comm``) and the batched and
constraint-sharded steps (``sharding``), the counterpart of ``bepuphysics2_tpu.parallel``."""
