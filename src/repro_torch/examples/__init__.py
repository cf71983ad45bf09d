"""The port's twins of the JAX package's `examples/`, each run as
`python -m repro_torch.examples.<name>`."""
