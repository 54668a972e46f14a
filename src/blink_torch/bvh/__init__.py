"""Host-side BVH builders (numpy)."""
