"""Model configurations of the port's CNN lane (the paper's CNN shape
tables)."""
