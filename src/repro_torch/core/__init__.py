"""The analytic leftovers the serving runtime needs: chip table and traffic
patterns (copies of the reference's jax-free ``core`` modules)."""
