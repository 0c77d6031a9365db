"""Object storage the indexes are laid out in (the port's copy)."""
