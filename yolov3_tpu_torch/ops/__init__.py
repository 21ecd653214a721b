"""Device ops of the port: preprocess, the K1/K2 kernel wrappers, NMS."""
