"""Host IO: image decode."""
