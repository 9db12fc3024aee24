"""Build and ctypes binding of the CUDA kernels in ``csrc/``.

The kernel wrappers live beside their plain PyTorch versions in the ops
modules: ``ops.segmentation.propagate_labels`` (K1, ``csrc/label_prop.cu``),
``ops.features.label_features`` (K2, ``csrc/pick_features.cu``) and
``ops.knn.knn`` (K3, ``csrc/knn.cu``).  Each keeps an integer
``launches`` attribute that counts its kernel launches.
"""
