"""Runtime helpers: weight carrying between the JAX package and the port,
and the device an entry point runs on."""
