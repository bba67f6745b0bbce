"""Host copies of the JAX package's audiokit helpers the port needs."""
