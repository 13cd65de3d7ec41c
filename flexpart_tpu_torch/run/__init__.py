"""Run layer of the port: the simulation loop."""
