"""The clouds and shapes that stress K2's selection (csrc/geometry.cuh
`knn_query`) and K16, shared by the K2 and K16 tests.

`hard_cloud` turns a uniform [B, N, 3] cloud in [-1, 1]^3 (a numpy array
or a torch tensor, changed in place) into one of KNN_CLOUDS:
  * "uniform": left as it is;
  * "tied": every fifth point a copy of the one before it and the first
    cloud on a half-unit lattice (equal distances at distinct indices);
  * "lane": the points of one lane of K2's warps (index = 31 mod 32) moved
    8 units away, so that lane's nearest key sets the selection's threshold
    above nearly every other key (the exact scan's path on the card).
"""

# (N, k) the card tests take K2 and K16 at: k = N, the validate scripts'
# (64, 4), a ragged cloud, k = 1, the pretrain and semseg clouds, and the
# largest k the threshold select takes (KNN_KMAX)
KNN_SHAPES = ((33, 33), (64, 4), (1000, 32), (1024, 1), (2048, 32), (4096, 32), (4096, 128))
KNN_CLOUDS = ("uniform", "tied", "lane")


def hard_cloud(xyz, kind: str):
    """`xyz` made a cloud of `kind` (module docstring), in place; returned."""
    if kind == "tied":
        xyz[:, 1::5] = xyz[:, 0::5][:, :xyz[:, 1::5].shape[1]]
        xyz[0] = (xyz[0] * 2).round() / 2
    elif kind == "lane":
        xyz[:, 31::32, 0] += 8.0
    elif kind != "uniform":
        raise ValueError(f"unknown cloud {kind!r}")
    return xyz
