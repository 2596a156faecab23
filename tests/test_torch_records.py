"""The kernel records agree: ROADMAP.md §2's kernel table gives each
kernel the device ms that PERF.md §6's kernel table gives it (the newest
card run), so a later reader of either file sees the same numbers."""

import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"\d+\.\d{4}")


def device_ms(path: pathlib.Path, heading: str, column: int) -> dict[str, list[float]]:
    """Kernel label -> the device ms of its rows, in row order, from the
    first table under ``heading``: the 4-decimal numbers of cell
    ``column`` before any bracket (brackets hold earlier runs)."""
    text = path.read_text()
    rows = {}
    for line in text[text.index(heading):].splitlines():
        if not line.startswith("| K"):
            if rows and not line.startswith("|"):
                break
            continue
        cells = [c.strip() for c in line.replace("\\|", "/").strip().strip("|").split("|")]
        rows.setdefault(cells[0], []).extend(float(v) for v in NUMBER.findall(cells[column].split("(")[0]))
    return rows


def test_roadmap_kernel_table_matches_perf():
    roadmap = device_ms(ROOT / "ROADMAP.md", "### 2. TPU kernels to port", 4)
    perf = device_ms(ROOT / "PERF.md", "### Kernel table", 4)
    assert len(roadmap) == 11 and roadmap.keys() == perf.keys()
    for kernel, times in roadmap.items():
        assert times and times == perf[kernel], kernel
