"""What the port does not run yet raises, and names its ROADMAP item.

Each message names the item by its title ("ROADMAP.md §1, data"), not
by a number that a renumbering of the queue would leave pointing elsewhere.
"""

import pytest


def _jpeg_view(tmp_path):
    """A progressive JPEG: its SOI and SOF2 segment."""
    from neat_tpu_torch.data.datasets import _load_rgb

    path = tmp_path / "image_0000.jpg"
    sof2 = b"\xff\xc2\x00\x11\x08\x00\x08\x00\x08\x03\x01\x22\x00\x02\x11\x01\x03\x11\x01"
    path.write_bytes(b"\xff\xd8" + sof2 + b"\xff\xd9")
    _load_rgb(str(path))


def _train_distributed(tmp_path):
    from neat_tpu_torch.train.runner import main

    main(["--conf", "confs/abc-neat-a.conf", "--distributed", "--device", "cpu"])


def _finalize_mesh(tmp_path):
    from neat_tpu_torch.wireframe.finalize import main

    main(["--conf", "run/runconf.conf", "--mesh", "4"])


def _render_eval_mesh(tmp_path):
    from neat_tpu_torch.evaluation.render_eval import main

    main(["--conf", "run/runconf.conf", "--mesh", "4"])


@pytest.mark.parametrize(
    "call,item",
    [
        (_jpeg_view, "ROADMAP.md §1, data"),
        (_train_distributed, "ROADMAP.md §1, multi-GPU"),
        (_finalize_mesh, "ROADMAP.md §1, multi-GPU"),
        (_render_eval_mesh, "ROADMAP.md §1, multi-GPU"),
    ],
    ids=["jpeg_view", "train_distributed", "finalize_mesh", "render_eval_mesh"],
)
def test_unported_paths_raise_and_name_their_item(call, item, tmp_path):
    with pytest.raises(NotImplementedError) as err:
        call(tmp_path)
    assert item in str(err.value)
    assert "item " not in str(err.value)  # no item number
