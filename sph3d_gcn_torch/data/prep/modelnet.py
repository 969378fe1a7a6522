"""ModelNet40 record preparation (counterpart of
``sph3d_gcn_tpu/data/prep/modelnet.py``; a port of
`io/make_tfrecord_modelnet.py`).

Per shape: farthest-point sample to 10k points (the reference runs its GPU
FPS op for this, ref make_tfrecord_modelnet.py:72-87; here the port's
``ops.sample.farthest_point_sample`` on the caller's device: K1 on the
card, its plain version on the CPU, the same indices on both), unit-sphere
normalize in numpy (ref :93-95), write records {xyz_raw, normal_raw,
label} in 1024-shape chunks (ref :105-120). The records equal the JAX
package's byte for byte.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sph3d_gcn_torch.data.tfrecord import TFRecordWriter


def prepare_shape(
    xyz: np.ndarray, normal: np.ndarray | None, num_point: int = 10000,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray | None]:
    """FPS to ``num_point`` on ``device`` and unit-sphere normalize one
    shape."""
    if xyz.shape[0] < num_point:
        raise ValueError(
            f"point cloud size {xyz.shape[0]} < requested {num_point}"
        )
    if xyz.shape[0] > num_point:
        from sph3d_gcn_torch.ops.sample import farthest_point_sample

        cloud = torch.from_numpy(xyz[None].astype(np.float32)).to(device)
        idx = farthest_point_sample(num_point, cloud)[0].cpu().numpy()
        xyz = xyz[idx]
        if normal is not None:
            normal = normal[idx]
    xyz = xyz - xyz.mean(axis=0)
    scale = np.sqrt(np.max(np.sum(np.square(xyz), axis=1)))
    xyz = (xyz / scale).astype(np.float32)
    return xyz, None if normal is None else normal.astype(np.float32)


def make_modelnet_records(
    data_dir: str,
    filelist: str,
    classlist: str,
    store_folder: str,
    num_point: int = 10000,
    chunksize: int = 1024,
    device: str | torch.device = "cuda",
) -> list[str]:
    """Write ModelNet tfrecords from the txt-per-shape layout
    (ref make_tfrecord_modelnet.py:33-121), the shapes sampled on
    ``device``. Returns the written file paths, also listed in
    ``<store_folder>/<phase>_files.txt``."""
    phase = filelist.split("_")[-1]
    with open(os.path.join(data_dir, filelist + ".txt")) as f:
        dataset = [line.rstrip() for line in f]
    with open(os.path.join(data_dir, classlist + ".txt")) as f:
        classes = [line.rstrip() for line in f]
    os.makedirs(store_folder, exist_ok=True)

    written = []
    writer = None
    for i, name in enumerate(dataset):
        classname = "_".join(name.split("_")[:-1])
        path = os.path.join(data_dir, classname, name + ".txt")
        data = np.loadtxt(path, delimiter=",", dtype=np.float32)
        if data.ndim != 2 or data.shape[1] != 6:
            raise ValueError(f"{path}: expects xyz+normal columns")
        xyz, normal = prepare_shape(data[:, 0:3], data[:, 3:6], num_point,
                                    device)
        if i % chunksize == 0:
            if writer is not None:
                writer.close()
            out = os.path.join(
                store_folder, f"data_{phase}{i // chunksize}.tfrecord"
            )
            writer = TFRecordWriter(out)
            written.append(out)
        writer.write_example({
            "normal_raw": normal.tobytes(),
            "label": np.int64(classes.index(classname)),
            "xyz_raw": xyz.tobytes(),
        })
    if writer is not None:
        writer.close()
    if phase in ("train", "test"):
        with open(os.path.join(store_folder, f"{phase}_files.txt"), "w") as f:
            for p in written:
                f.write(p + "\n")
    return written
