"""Training of the port (mirrors ``repro.train``): the train state and
step, and the fault-tolerant ``Trainer``."""
