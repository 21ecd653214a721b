from readers import h2d_ms as read  # noqa: F401
