"""Generation pipelines of the port."""
