"""Image IO: the native libjpeg codec (a missing codec raises)."""
