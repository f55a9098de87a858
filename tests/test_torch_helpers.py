"""The port's last public helpers against their JAX counterparts on the
CPU: geometry/se3.py `so3_exp`, `identity`, `rotate` and `normalize_svd`,
ops/image.py `image_gradients` and `extract_patches`, and parallel/mesh.py
`replicated` and `lm_sharded` (each rank's share, beside the shards a JAX
NamedSharding places on the 8 virtual CPU devices of tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackingbench_slam_tpu.geometry import se3 as j_se3
from trackingbench_slam_tpu.ops import image as j_image
from trackingbench_slam_tpu.parallel import mesh as j_mesh
from trackingbench_slam_tpu_torch.geometry import se3 as t_se3
from trackingbench_slam_tpu_torch.ops import image as t_image
from trackingbench_slam_tpu_torch.parallel import mesh as t_mesh
from tests.conftest import make_textured_image


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("scale", [0.0, 1e-5, 3e-3, 0.4, 2.5])
def test_so3_exp_matches_reference(scale):
    """Within 1e-6 from the identity to large angles, through the
    Taylor branch below theta^2 = 1e-6; a batch of axes at once equals
    each axis alone."""
    r = np.random.RandomState(0)
    phis = (r.normal(size=(6, 3)) * scale).astype(np.float32)
    got = t_se3.so3_exp(t(phis)).numpy()
    for phi, R in zip(phis, got):
        ref = np.asarray(j_se3.so3_exp(jnp.asarray(phi)))
        np.testing.assert_allclose(R, ref, atol=1e-6)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=2e-6)
        np.testing.assert_array_equal(t_se3.so3_exp(t(phi)).numpy(), R)


def test_so3_exp_is_the_rotation_block_of_exp():
    xi = np.float32([0.1, -0.2, 0.3, 0.05, -0.4, 0.2])
    np.testing.assert_allclose(t_se3.so3_exp(t(xi[3:])).numpy(),
                               t_se3.exp(t(xi)).numpy()[:3, :3], atol=1e-7)


def test_identity_and_rotate_match_reference():
    np.testing.assert_array_equal(t_se3.identity().numpy(),
                                  np.asarray(j_se3.identity()))
    assert t_se3.identity(torch.float64).dtype == torch.float64
    r = np.random.RandomState(1)
    T = np.asarray(j_se3.exp(jnp.asarray(
        r.normal(size=6).astype(np.float32))))
    vecs = r.normal(size=(5, 7, 3)).astype(np.float32)
    ref = np.asarray(j_se3.rotate(jnp.asarray(T), jnp.asarray(vecs)))
    got = t_se3.rotate(t(T), t(vecs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # a rotation: no translation, lengths kept
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1),
                               np.linalg.norm(vecs, axis=-1), rtol=1e-5)


@pytest.mark.parametrize("noise", [1e-3, 0.2])
def test_normalize_svd_matches_reference(noise):
    """The polar projection of a perturbed rotation, near and far from
    orthonormal: within 1e-5 of JAX's, orthonormal with det +1, the
    translation untouched; a stack of poses equals each alone."""
    r = np.random.RandomState(2)
    Ts = []
    for _ in range(4):
        T = np.asarray(j_se3.exp(jnp.asarray(
            r.normal(size=6).astype(np.float32))))
        T = T.copy()
        T[:3, :3] += (r.normal(size=(3, 3)) * noise).astype(np.float32)
        Ts.append(T)
    Ts = np.stack(Ts)
    got = t_se3.normalize_svd(t(Ts)).numpy()
    for T, G in zip(Ts, got):
        ref = np.asarray(j_se3.normalize_svd(jnp.asarray(T)))
        np.testing.assert_allclose(G, ref, atol=1e-5)
        np.testing.assert_allclose(G[:3, :3] @ G[:3, :3].T, np.eye(3),
                                   atol=1e-5)
        assert abs(np.linalg.det(G[:3, :3]) - 1) < 1e-5
        np.testing.assert_array_equal(G[:3, 3], T[:3, 3])
        np.testing.assert_array_equal(G[3], [0, 0, 0, 1])
        np.testing.assert_allclose(
            t_se3.normalize_svd(t(T)).numpy(), G, atol=1e-6)


def test_normalize_svd_of_a_reflection_is_a_rotation():
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.diag([1.0, 1.0, -1.0]).astype(np.float32)
    T[0, 1] = 0.01
    ref = np.asarray(j_se3.normalize_svd(jnp.asarray(T)))
    got = t_se3.normalize_svd(t(T)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert abs(np.linalg.det(got[:3, :3]) - 1) < 1e-5


def test_image_gradients_match_reference():
    img = make_textured_image(37, 53, seed=4)
    gx_j, gy_j = j_image.image_gradients(jnp.asarray(img))
    gx, gy = t_image.image_gradients(t(img))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(gx_j))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(gy_j))
    assert not gx[:, [0, -1]].any() and not gy[[0, -1], :].any()
    assert gx.abs().max() > 1


@pytest.mark.parametrize("half", [1, 4])
def test_extract_patches_matches_reference(half):
    """Patches at sub-pixel centres, some hanging over the border (zero
    there): within 1e-4 of JAX's."""
    img = make_textured_image(48, 64, seed=5)
    r = np.random.RandomState(3)
    centers = np.stack([r.uniform(-3, 67, 40), r.uniform(-3, 51, 40)],
                       -1).astype(np.float32)
    ref = np.asarray(j_image.extract_patches(jnp.asarray(img),
                                             jnp.asarray(centers), half))
    got = t_image.extract_patches(t(img), t(centers), half).numpy()
    assert got.shape == (40, 2 * half + 1, 2 * half + 1)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # an integer centre's patch is the image's window
    c = np.float32([[20.0, 30.0]])
    win = t_image.extract_patches(t(img), t(c), half).numpy()[0]
    np.testing.assert_array_equal(
        win, img[30 - half:31 + half, 20 - half:21 + half])


@pytest.mark.parametrize("dp,lm,axis", [(1, 8, 0), (2, 4, 0), (2, 4, 1),
                                        (1, 2, 1)])
def test_mesh_shares_match_reference_shards(dp, lm, axis):
    """Every rank's lm_sharded share equals the shard that JAX's
    lm_sharded places on the device at the same mesh position, and its
    replicated share is the whole array, as JAX's replicated places it."""
    devices = jax.devices()
    if len(devices) < dp * lm:
        pytest.skip(f"{len(devices)} JAX devices")
    jm = j_mesh.make_mesh(lm=lm, dp=dp, devices=devices)
    x = np.arange(16 * 24, dtype=np.float32).reshape(16, 24)
    sharded = jax.device_put(jnp.asarray(x), j_mesh.lm_sharded(jm,
                                                                axis=axis))
    repl = jax.device_put(jnp.asarray(x), j_mesh.replicated(jm))
    by_device = {s.device: np.asarray(s.data)
                 for s in sharded.addressable_shards}
    repl_by_device = {s.device: np.asarray(s.data)
                      for s in repl.addressable_shards}
    grid = tuple(tuple(range(d * lm, (d + 1) * lm)) for d in range(dp))
    for d in range(dp):
        for j in range(lm):
            mesh = t_mesh.RankMesh(grid=grid, groups=(None,) * dp,
                                   rank=grid[d][j])
            share = t_mesh.lm_sharded(mesh, t(x), axis=axis).numpy()
            np.testing.assert_array_equal(share,
                                          by_device[jm.devices[d, j]])
            np.testing.assert_array_equal(
                t_mesh.replicated(mesh, t(x)).numpy(),
                repl_by_device[jm.devices[d, j]])


def test_lm_sharded_needs_equal_blocks():
    mesh = t_mesh.RankMesh(grid=((0, 1, 2),), groups=(None,), rank=1)
    with pytest.raises(ValueError, match="equal blocks"):
        t_mesh.lm_sharded(mesh, torch.zeros(16, 4))
    assert t_mesh.lm_sharded(mesh, torch.arange(12).reshape(3, 4),
                             axis=0).tolist() == [[4, 5, 6, 7]]
    # a world of one: the whole array is this rank's share
    one = t_mesh.make_mesh()
    assert t_mesh.lm_sharded(one, torch.arange(6)).tolist() == list(range(6))
