"""Networks, solver, timestep protocol and the PDE models of the port."""
