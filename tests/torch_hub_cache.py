"""An offline HuggingFace cache for the hub-name tests: repositories laid out
as `huggingface_hub` keeps them (`models--{org}--{name}/refs/main` naming a
revision, `snapshots/{revision}/...` holding the files), and
`huggingface_hub` pointed at it with every HTTP session offline."""

import shutil
from pathlib import Path

REVISION = "0123456789abcdef0123456789abcdef01234567"


def write_repo(cache_dir: Path, name: str, src: Path) -> Path:
    """Copy the directory `src` into the cache as repository `name`'s main
    revision; returns the snapshot directory."""
    folder = Path(cache_dir) / ("models--" + name.replace("/", "--"))
    (folder / "refs").mkdir(parents=True, exist_ok=True)
    (folder / "refs" / "main").write_text(REVISION)
    snapshot = folder / "snapshots" / REVISION
    shutil.copytree(src, snapshot)
    return snapshot


def go_offline(monkeypatch, cache_dir: Path) -> None:
    """Point `huggingface_hub` at `cache_dir` with `HF_HUB_OFFLINE` set, and
    make every HTTP session it opens from here on refuse to connect (the
    sessions it caches per thread are dropped, so none made earlier is
    reused)."""
    import huggingface_hub
    from huggingface_hub.utils import _http

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache_dir))
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(huggingface_hub.constants, "HF_HUB_CACHE", str(cache_dir))

    def offline_session():
        import requests

        session = requests.Session()
        session.mount("http://", _http.OfflineAdapter())
        session.mount("https://", _http.OfflineAdapter())
        return session

    monkeypatch.setattr(_http, "_GLOBAL_BACKEND_FACTORY", offline_session)
    _http.reset_sessions()
