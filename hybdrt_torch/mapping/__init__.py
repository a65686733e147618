"""Map-level methods of the port: the group resolve."""
