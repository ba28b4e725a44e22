"""Models of the port: the paper's MLP classifiers."""
