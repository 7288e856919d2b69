"""Weight bridge from the JAX package and the inference step."""
