"""Training runtime of the port: config, engine, schedules, loss scaling."""
