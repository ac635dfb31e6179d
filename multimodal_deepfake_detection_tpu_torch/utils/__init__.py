"""Weight bridge from the JAX package's param/state trees."""
