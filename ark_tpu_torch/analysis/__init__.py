"""Analysis helpers of the port."""
