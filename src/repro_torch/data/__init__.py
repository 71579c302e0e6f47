"""Data pipelines of the port: synthetic batches made with numpy."""
