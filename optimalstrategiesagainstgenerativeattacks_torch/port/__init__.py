"""Weight transplant between the JAX reference and this package."""
