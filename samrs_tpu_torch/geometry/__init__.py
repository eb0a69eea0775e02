"""Box and polygon geometry of the port's generate driver (numpy only)."""
