"""Weight conversion into the port."""

from .from_jax import from_jax, load_jax_variables

__all__ = ["from_jax", "load_jax_variables"]
