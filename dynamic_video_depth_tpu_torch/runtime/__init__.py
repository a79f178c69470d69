"""Runtime helpers: the entries' options (``config``), checkpoints in the
reference's torch format, the loggers, weight carrying between the JAX
package and the port, and the device an entry point runs on."""
