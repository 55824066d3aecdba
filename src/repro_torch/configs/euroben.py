"""EuroBen benchmark inputs exactly as the paper specifies them (§3);
the counterpart of ``repro.configs.euroben``."""

# mod2am matrix sizes (paper §3.1)
MOD2AM_SIZES = (10, 20, 50, 100, 192, 200, 500, 512, 576, 1000, 1024, 2000,
                2048)

# mod2as: see repro_torch.numerics.sparse.MOD2AS_TABLE1
# CG:      see repro_torch.numerics.sparse.CG_TABLE2

# mod2f FFT data sizes (paper §3.3)
MOD2F_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536,
               131072, 262144, 524288, 1048576)

# SuperMIG Westmere-EX reference peaks (paper §3): per core / per node, DP
WESTMERE_CORE_PEAK_GFLOPS = 9.6
WESTMERE_NODE_PEAK_GFLOPS = 384.0
