"""Networks, layers and the serving forward of the port."""
