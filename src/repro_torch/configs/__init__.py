"""Architecture configurations the port supports (yi-6b so far)."""
