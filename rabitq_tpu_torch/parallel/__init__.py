"""Row sharding over a list of devices, driven from one process."""
