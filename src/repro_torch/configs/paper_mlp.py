"""The paper's own experimental networks (He et al. 2017, §5).

MNIST:  784-400-10 (Fig. 3) and 784-400-150-10 (Fig. 4), tanh.
TIMIT:  360 features, 3 hidden layers x 512 units, 1973 classes (Fig. 5).
"""

MNIST_FIG3 = (784, 400, 10)
MNIST_FIG4 = (784, 400, 150, 10)
TIMIT_FIG5 = (360, 512, 512, 512, 1973)
