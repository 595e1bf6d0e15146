"""One module per mode; ``run(files, seed=, seconds=, trace=, device=, t_start=)``
returns the run's record (see ``harness.run_cell``)."""
