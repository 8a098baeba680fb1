"""Host-side data partitioning."""
