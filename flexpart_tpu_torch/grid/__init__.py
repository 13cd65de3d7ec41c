"""Output layer of the port: output-grid geometry, accumulators,
concentration sampling, receptors, gross fluxes, the initial-condition
sensitivity and plume trajectories."""
