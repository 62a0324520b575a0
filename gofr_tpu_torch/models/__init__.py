"""Models of the port: the Llama decoder and the params bridge from the JAX package."""
