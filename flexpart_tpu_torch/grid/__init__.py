"""Output layer of the port: output-grid geometry, accumulators and
concentration sampling."""
