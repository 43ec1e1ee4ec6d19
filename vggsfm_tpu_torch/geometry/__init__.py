"""Camera geometry of the port."""
