"""Dataset acquisition tools, port of ttts_tpu/data/spider.py (reference
ttts/spider/): the reference crawls podcast audio with selenium (spider.py,
zh.player.fm) and Ximalaya through xmlyfetcher (xmly_spider.py), with a bulk
downloader (download.py) and duration accounting (duration_calc.sh). Here,
standard library only:

  - `download(urls, out_dir)`, a plain urllib fetcher;
  - `total_duration(dir)`, seconds of WAV audio from the headers alone;
  - `crawl_playerfm` / `crawl_xmly`, the crawlers' extraction and
    pagination (html.parser in place of BeautifulSoup) with the page
    fetcher injected (`fetch(url) -> html`: a browser session on a crawl
    host, a stub in tests); the browser and xmlyfetcher stay outside.

usage: python -m ttts_tpu_torch.data.spider duration --dir clips/
       python -m ttts_tpu_torch.data.spider download --url-list urls.txt --out-dir raw/
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import urllib.request
import wave
from html.parser import HTMLParser
from typing import Callable, Iterable, List, Optional

from ttts_tpu_torch.utils.logging import get_logger

log = get_logger("spider")


def download(urls: Iterable[str], out_dir: str, timeout: float = 60.0) -> List[str]:
    """Fetch each URL into out_dir under its last path component → the
    paths written (a failed fetch is logged and skipped)."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for url in urls:
        dst = out / (url.rstrip("/").rsplit("/", 1)[-1] or "download")
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r, open(dst, "wb") as f:
                f.write(r.read())
            written.append(str(dst))
        except Exception as e:  # a bad URL must not end the batch
            log.warning("failed %s: %s", url, e)
    return written


def total_duration(directory: str) -> float:
    """Total seconds of WAV audio under `directory`, read from the headers
    (the native library's wav_info, else the wave module); unreadable files
    are skipped."""
    from ttts_tpu_torch.data.audio import WavInfo, _native

    total, lib = 0.0, _native()
    for p in pathlib.Path(directory).rglob("*.wav"):
        try:
            if lib is not None:
                info = WavInfo()
                if lib.wav_info(str(p).encode(), ctypes.byref(info)) == 0:
                    total += info.frames / max(info.sample_rate, 1)
            else:
                with wave.open(str(p)) as w:
                    total += w.getnframes() / max(w.getframerate(), 1)
        except Exception:  # a broken header counts as no audio
            continue
    return total


class _AnchorParser(HTMLParser):
    """(href, class, text) of every <a>."""

    def __init__(self):
        super().__init__()
        self.anchors: List[tuple] = []
        self._cur = None

    def handle_starttag(self, tag, attrs):
        if tag == "a":
            d = dict(attrs)
            self._cur = [d.get("href"), d.get("class", ""), ""]

    def handle_data(self, data):
        if self._cur is not None:
            self._cur[2] += data

    def handle_endtag(self, tag):
        if tag == "a" and self._cur is not None:
            self.anchors.append(tuple(self._cur))
            self._cur = None


def _anchors(html: str) -> List[tuple]:
    p = _AnchorParser()
    p.feed(html)
    return p.anchors


def extract_playerfm_audio_urls(html: str) -> List[str]:
    """A player.fm episode page → its .m4a URLs, every other one (each
    episode's link appears twice in the page, spider.py:45-54)."""
    return [h for h, _, _ in _anchors(html) if h and h.endswith(".m4a")][::2]


def parse_xmly_album_links(html: str) -> List[str]:
    """A Ximalaya category page → the hrefs of /album/<id> anchors."""
    return [h for h, _, _ in _anchors(html) if h and re.search(r"/album/\d+$", h)]


def parse_xmly_next_page(html: str, page_num: int) -> Optional[str]:
    """The href of the <a class="page-link"> whose text is `page_num`."""
    for h, cls, text in _anchors(html):
        if "page-link" in (cls or "") and text.strip() == str(page_num):
            return h
    return None


def crawl_playerfm(series_url: str, fetch: Callable[[str], str]) -> List[str]:
    """A player.fm series → its audio URLs, the page from `fetch` (which on
    a crawl host scrolls the page so that it loads every episode)."""
    return extract_playerfm_audio_urls(fetch(series_url))


def crawl_xmly(base_url: str, fetch: Callable[[str], str], num_pages: int = 50) -> List[str]:
    """A Ximalaya category → the album links of its pages, following the
    page links up to `num_pages` (xmly_spider.py get_all_album_links)."""
    links: List[str] = []
    page_url, page_count = base_url, 1
    while page_url and page_count < num_pages:
        html = fetch(page_url)
        links.extend(parse_xmly_album_links(html))
        nxt = parse_xmly_next_page(html, page_count + 1)
        page_url = f"https://www.ximalaya.com{nxt}" if nxt else None
        page_count += 1
    return links


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("download")
    s.add_argument("--url-list", required=True)
    s.add_argument("--out-dir", required=True)
    s = sub.add_parser("duration")
    s.add_argument("--dir", required=True)
    args = p.parse_args(argv)
    if args.cmd == "download":
        with open(args.url_list) as f:
            urls = [line.strip() for line in f if line.strip()]
        written = download(urls, args.out_dir)
        log.info("downloaded %d/%d", len(written), len(urls))
    else:
        print(f"{total_duration(args.dir):.1f} seconds")


if __name__ == "__main__":
    main()
