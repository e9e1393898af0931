"""Device backend of the port: tables as torch tensors, relational kernels,
expression evaluation and the plan executor (counterpart of
``nds_tpu/engine/jax_backend``)."""
