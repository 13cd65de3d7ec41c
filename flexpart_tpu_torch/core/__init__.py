"""Core particle engine of the port: state, draws, interpolation,
turbulence and the fixed-step advance."""
