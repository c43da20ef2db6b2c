"""Networks, layers, updaters and weight init of the port: the serving
forward and training."""
