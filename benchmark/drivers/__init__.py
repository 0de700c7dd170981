"""One driver per model entry of the program, named by a configuration's
`driver` key: it builds the model as the program's command line does and
runs its timesteps."""
