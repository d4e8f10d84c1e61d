"""Low-level ops: the Pallas inversion kernel and XLA compute primitives."""
