"""Analysis of the port without hardware (the dry run's roofline)."""
