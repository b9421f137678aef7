"""The analytic leftovers the serving runtime needs: chip table, traffic
patterns, and the roofline performance model with the paper's study
models (copies of the reference's jax-free ``core`` modules)."""
