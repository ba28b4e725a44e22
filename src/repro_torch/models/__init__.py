"""Models of the port: the paper's MLP classifiers and the dense decoder
transformers."""
