"""data of the torch package."""
