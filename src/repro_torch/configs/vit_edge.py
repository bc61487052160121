"""The paper's own catalog: ViT-class dynamic DNNs on CIFAR-10 (Tables II/III).

Memory in MB, FLOPs in GFLOPs per request, loading times in seconds
(cloud->BS at the paper's 800 Mbps with measured constants).  Data only,
copied from the paper's tables.
"""

# Table II — the three ViT submodels
VIT_SUBMODELS = [
    {"memory_mb": 174.32, "gflops": 5.70, "precision": 0.8417},
    {"memory_mb": 227.42, "gflops": 7.56, "precision": 0.9413},
    {"memory_mb": 342.05, "gflops": 11.29, "precision": 0.9894},
]

# Table III — loading latency (s): row = original submodel (0 = none),
# col = target submodel.
VIT_LOAD_S = [
    [0.68860, 0.87696, 1.05821],   # from scratch
    [0.00000, 0.24794, 0.46098],   # from submodel 1
    [0.04238, 0.00000, 0.25082],   # from submodel 2
    [0.04725, 0.04242, 0.00000],   # from submodel 3
]
