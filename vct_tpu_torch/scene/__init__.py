"""Scenes for the port: its own copies of the JAX package's host-side
scene modules (mesh, Cornell box, atrium) and the texture atlas."""
