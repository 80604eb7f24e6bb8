"""Multimodal input pipeline (counterpart of
llama_box_tpu/server/multimodal.py): image fetch and decode, the vision
and audio towers behind a projected-embedding LRU, and the prompt chunks.

- image_url parts: a data-URI (or bare) base64 payload, or a server-side
  HTTP fetch (15 s timeout) over the standard library's urllib.request
  (the JAX package uses `requests`)
- `<MTMD/>` markers in the templated prompt, wrapped in each family's
  special tokens, split and interleaved with embedding chunks
- FNV-hash -> projected-embedding LRU (--max-projected-cache)
- negative "dummy tokens" stand in for the media positions, so the
  prefix cache recognises a repeated image (z_multimodal.hpp:90)

Images decode and resize through Pillow, imported where an image is
decoded, as the JAX package does. The towers run on the device their
parameters live on, in the request's thread, taking turns with the
engine's graph captures (cuda_graph.CAPTURE_LOCK); their embeddings come
back to the host as f32.
"""

from __future__ import annotations

import base64
import io
import math
import re
import threading
import urllib.request
from collections import OrderedDict

import numpy as np
import torch

from ..utils.logging import SRV_INF
from ..utils.text import fnv1a_64
from .cuda_graph import CAPTURE_LOCK

MTMD_MARKER = "<MTMD/>"

_DATA_URI_RE = re.compile(r"^data:image/[a-zA-Z0-9.+-]+;base64,(.*)$", re.S)


def fetch_image_bytes(url: str, timeout: float = 15.0) -> bytes:
    """A data-URI, a remote HTTP(S) fetch (the reference fetches
    server-side, httpserver.hpp:1027-1064) or bare base64."""
    m = _DATA_URI_RE.match(url)
    if m:
        return base64.b64decode(m.group(1))
    if url.startswith("http://") or url.startswith("https://"):
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read()
    return base64.b64decode(url)


def open_image(data: bytes):
    """Image bytes -> a Pillow image (Pillow is imported here only)."""
    from PIL import Image
    return Image.open(io.BytesIO(data))


def _png(img) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


class MultimodalProcessor:
    """Owns the vision (and optional audio) towers; encodes media to
    LM-space embeddings with an LRU cache keyed by content FNV hash."""

    def __init__(self, clip_cfg, clip_params, max_cache: int = 8,
                 audio_cfg=None, audio_params=None):
        self.cfg = clip_cfg
        self.params = clip_params
        self.audio_cfg = audio_cfg
        self.audio_params = audio_params
        self.max_cache = max_cache
        self.max_image_size = 0   # --visual-max-image-size (0 = unlimited)
        self._cache: OrderedDict[int, object] = OrderedDict()
        self._grids: dict[int, tuple[int, int]] = {}  # qwen2vl token grids
        self._lock = threading.Lock()  # one encode at a time (ref :3385)

    @property
    def device(self) -> torch.device:
        """The towers' device."""
        w = self.params.get("patch_embd")
        return (w if w is not None else self.audio_params["conv1_w"]).device

    @property
    def supports_image(self) -> bool:
        return self.params.get("patch_embd") is not None

    def image_grid(self, h: int) -> tuple[int, int] | None:
        """(h_tokens, w_tokens) of a cached native-size image (M-RoPE)."""
        return self._grids.get(h)

    @property
    def supports_audio(self) -> bool:
        return self.audio_cfg is not None

    @property
    def audio_family(self) -> str | None:
        """"qwen2a" (qwen2-audio) or "ultravox": the audio scaffold
        (httpserver.hpp:6000-6030)."""
        if self.audio_cfg is None:
            return None
        pt = self.audio_cfg.get("proj_type", "")
        if "qwen2a" in pt or "qwen2.5o" in pt:
            return "qwen2a"
        if "ultravox" in pt:
            return "ultravox"
        return None

    def _remember(self, h: int, value) -> None:
        """Insert under the lock; evict the oldest past max_cache."""
        self._cache[h] = value
        while len(self._cache) > self.max_cache:
            old_h, _ = self._cache.popitem(last=False)
            self._grids.pop(old_h, None)

    def _cached(self, h: int):
        with self._lock:
            if h in self._cache:
                self._cache.move_to_end(h)
                return self._cache[h]
        return None

    def pixels(self, image_bytes: bytes):
        """Decode and preprocess one image as the tower takes it: (pixels
        [H, W, 3] f32, grid (gh, gw) for the native-size towers or
        None)."""
        from PIL import Image

        from ..models.clip import (pixtral_fit_resize, preprocess_image,
                                   preprocess_image_native,
                                   qwen2vl_smart_resize)
        img = open_image(image_bytes)
        if self.max_image_size > 0 and max(img.size) > self.max_image_size:
            img.thumbnail((self.max_image_size, self.max_image_size),
                          Image.BICUBIC)
        if self.cfg.projector == "pixtral":
            W, H = pixtral_fit_resize(*img.size, self.cfg,
                                      self.max_image_size)
        elif "qwen2" in self.cfg.projector:     # qwen2vl + qwen2.5vl
            W, H = qwen2vl_smart_resize(*img.size, self.cfg,
                                        self.max_image_size)
        else:
            return preprocess_image(img, self.cfg), None
        P = self.cfg.patch_size
        return preprocess_image_native(img, self.cfg, (W, H)), (H // P, W // P)

    def tower(self, pixels: np.ndarray, grid) -> torch.Tensor:
        """The projected embeddings of preprocessed pixels, on the towers'
        device (the family's tower at its native grid where it has one)."""
        from ..models.clip import (encode_image_impl,
                                   encode_image_pixtral_impl,
                                   encode_image_qwen2vl_impl)
        x = torch.from_numpy(pixels).to(self.device)
        with torch.no_grad():
            if self.cfg.projector == "pixtral":
                return encode_image_pixtral_impl(self.params, self.cfg, x,
                                                 grid)
            if "qwen2" in self.cfg.projector:
                return encode_image_qwen2vl_impl(self.params, self.cfg, x,
                                                 grid)
            return encode_image_impl(self.params, self.cfg, x)

    def encode(self, image_bytes: bytes) -> tuple[np.ndarray, int]:
        """Returns (embeddings [N, proj_dim] f32, content hash)."""
        h = fnv1a_64(image_bytes)
        hit = self._cached(h)
        if hit is not None:
            return hit, h
        pixels, grid = self.pixels(image_bytes)
        with self._lock:
            if h not in self._cache:
                with CAPTURE_LOCK:
                    emb = self.tower(pixels, grid).float().cpu().numpy()
                if grid is not None:
                    m = (max(self.cfg.merge_size, 1)
                         if "qwen2" in self.cfg.projector else 1)
                    self._grids[h] = (grid[0] // m, grid[1] // m)
                self._remember(h, emb)
                SRV_INF("multimodal", "encoded image hash=%x -> %d tokens",
                        h, emb.shape[0])
            return self._cache[h], h

    def encode_audio(self, audio_bytes: bytes) -> tuple[np.ndarray, int]:
        """WAV bytes -> (embeddings [N, proj] f32, content hash)."""
        if self.audio_cfg is None:
            raise ValueError("this server has no audio encoder loaded")
        from ..models.audio import encode_audio
        h = fnv1a_64(audio_bytes)
        with self._lock:
            if h in self._cache:
                self._cache.move_to_end(h)
                return self._cache[h], h
            with CAPTURE_LOCK:
                emb = encode_audio(self.audio_cfg, self.audio_params,
                                   audio_bytes)
            self._remember(h, emb)
        return emb, h

    @property
    def minicpmv_version(self) -> int:
        return getattr(self.cfg, "minicpmv_version", 0)

    @property
    def is_llama4(self) -> bool:
        return "llama4" in getattr(self.cfg, "projector", "")

    def _encode_pieces(self, pieces: list) -> list:
        return [self.encode(_png(p))[0] for p in pieces]

    def encode_tiled_llama4(self, image_bytes: bytes):
        """Llama4 tiling: a best-aspect grid of tile-sized crops and an
        overview, each encoded on its own (httpserver.hpp:5846-5900).
        Returns (embs [tile..., overview], (gx, gy), hash)."""
        from PIL import Image
        h = fnv1a_64(image_bytes + b"/llama4")
        hit = self._cached(h)
        if hit is not None:
            return hit[0], hit[1], h
        img = open_image(image_bytes).convert("RGB")
        tiles, grid = llama4_slice(img, tile=self.cfg.image_size)
        overview = img.resize((self.cfg.image_size, self.cfg.image_size),
                              Image.BICUBIC)
        embs = self._encode_pieces(tiles + [overview])
        with self._lock:
            self._remember(h, (embs, grid))
        SRV_INF("multimodal", "llama4 tiled image hash=%x grid=%dx%d",
                h, grid[0], grid[1])
        return embs, grid, h

    def encode_sliced(self, image_bytes: bytes):
        """MiniCPM-V tiling: an overview and best-grid tiles (llama.cpp's
        uhd slicing; z_multimodal.hpp:105-131). Returns (embs [overview,
        tile...], (gx, gy), hash)."""
        h = fnv1a_64(image_bytes + b"/sliced")
        hit = self._cached(h)
        if hit is not None:
            return hit[0], hit[1], h
        img = open_image(image_bytes).convert("RGB")
        overview, tiles, grid = minicpmv_slice(img)
        embs = self._encode_pieces([overview] + tiles)
        with self._lock:
            self._remember(h, (embs, grid))
        SRV_INF("multimodal", "minicpmv sliced image hash=%x grid=%dx%d",
                h, grid[0], grid[1])
        return embs, grid, h

    def dummy_tokens(self, content_hash: int, n: int) -> list[int]:
        """Negative pseudo-token ids identifying this media in the prefix
        cache (z_multimodal.hpp:90)."""
        base = -(content_hash % (1 << 30)) - 2
        return [base - i for i in range(n)]


def _ensure_divide(length: float, patch: int) -> int:
    return max(int(round(length / patch)) * patch, patch)


def _best_resize(w: int, h: int, scale_res: int, patch: int,
                 allow_upscale: bool = False) -> tuple[int, int]:
    if w * h > scale_res * scale_res or allow_upscale:
        r = w / h
        w = scale_res * (r ** 0.5)
        h = scale_res / (r ** 0.5)
    return _ensure_divide(w, patch), _ensure_divide(h, patch)


def _best_grid(max_slice: int, multiple: int, log_ratio: float
               ) -> tuple[int, int]:
    best, best_err = (1, 1), float("inf")
    for m in (multiple - 1, multiple, multiple + 1):
        if m < 1 or m > max_slice:
            continue
        for gx in range(1, m + 1):
            if m % gx:
                continue
            gy = m // gx
            err = abs(log_ratio - math.log(gx / gy))
            if err < best_err:
                best, best_err = (gx, gy), err
    return best


def llama4_slice(img, tile: int = 336, max_tiles: int = 16):
    """Best-aspect grid of tile-size crops (llama4 vision tiling): (tiles
    row-major, (gx, gy)); no tiles for a small image (the overview alone
    carries it)."""
    from PIL import Image
    W, H = img.size
    multiple = min(math.ceil(W * H / (tile * tile)), max_tiles)
    if multiple <= 1:
        return [], (0, 0)
    gx, gy = _best_grid(max_tiles, multiple, math.log(W / H))
    resized = img.resize((gx * tile, gy * tile), Image.BICUBIC)
    tiles = [resized.crop((x * tile, y * tile, (x + 1) * tile,
                           (y + 1) * tile))
             for y in range(gy) for x in range(gx)]
    return tiles, (gx, gy)


def minicpmv_slice(img, scale_res: int = 448, patch: int = 14,
                   max_slice: int = 9):
    """LLaVA-UHD slicing (llama.cpp clip.cpp uhd_slice_image): (overview,
    tiles row-major, grid (gx, gy)); grid (0, 0) when no slicing is
    needed."""
    from PIL import Image
    W, H = img.size
    multiple = min(math.ceil(W * H / (scale_res * scale_res)), max_slice)
    if multiple <= 1:
        w, h = _best_resize(W, H, scale_res, patch)
        return img.resize((w, h), Image.BICUBIC), [], (0, 0)
    gx, gy = _best_grid(max_slice, multiple, math.log(W / H))
    ow, oh = _best_resize(W, H, scale_res, patch, allow_upscale=True)
    overview = img.resize((ow, oh), Image.BICUBIC)
    # refine: grid-aligned resize, then split
    rw = _ensure_divide(W, gx)
    rh = _ensure_divide(H, gy)
    bw, bh = _best_resize(rw // gx, rh // gy, scale_res, patch,
                          allow_upscale=True)
    refine = img.resize((bw * gx, bh * gy), Image.BICUBIC)
    tiles = [refine.crop((x * bw, y * bh, (x + 1) * bw, (y + 1) * bh))
             for y in range(gy) for x in range(gx)]
    return overview, tiles, (gx, gy)


# per-family image scaffolds (httpserver.hpp:5741-6054): the marker stays
# inside so the splitter still finds the insertion point; minicpmv and
# llama4 compose their tiled scaffolds in build_chunks
_SCAFFOLDS = {
    "qwen2vl": "<|vision_start|>" + MTMD_MARKER + "<|vision_end|>",
    "qwen25vl": "<|vision_start|>" + MTMD_MARKER + "<|vision_end|>",
    "gemma3": "<start_of_image>" + MTMD_MARKER + "<end_of_image>",
    "internvl": "<img>" + MTMD_MARKER + "</img>",
    "smolvlm": "<fake_token_around_image><global-img>" + MTMD_MARKER
               + "<fake_token_around_image>",
    "pixtral": MTMD_MARKER + "[IMG_END]",
}

# per-audio-tower scaffolds (httpserver.hpp:6000-6030): qwen2-audio wraps
# the audio in <|audio_bos|>/<|audio_eos|>; ultravox prefixes
# [BEGIN_AUDIO] with no closing token
_AUDIO_SCAFFOLDS = {
    "qwen2a": "<|audio_bos|>" + MTMD_MARKER + "<|audio_eos|>",
    "ultravox": "[BEGIN_AUDIO]" + MTMD_MARKER,
}


def scaffold_prompt(prompt: str, arch: str, media: list | None = None,
                    audio_family: str | None = None) -> str:
    """Wrap each media marker in the model family's special tokens; with
    `media` (a list of (kind, bytes)) each by its own modality."""
    img_wrap = _SCAFFOLDS.get(arch) or MTMD_MARKER
    aud_wrap = _AUDIO_SCAFFOLDS.get(audio_family or "") or MTMD_MARKER
    if media is None:
        return prompt.replace(MTMD_MARKER, img_wrap)
    kinds = [m[0] if isinstance(m, tuple) else "image" for m in media]
    parts = prompt.split(MTMD_MARKER)
    if len(parts) != len(kinds) + 1:
        return prompt.replace(MTMD_MARKER, img_wrap)
    out = [parts[0]]
    for kind, part in zip(kinds, parts[1:]):
        out.append(aud_wrap if kind == "audio" else img_wrap)
        out.append(part)
    return "".join(out)


def _split_media(prompt: str, media: list):
    media = [("image", m) if isinstance(m, (bytes, bytearray)) else m
             for m in media]
    parts = prompt.split(MTMD_MARKER)
    if len(parts) != len(media) + 1:
        raise ValueError(
            f"prompt has {len(parts) - 1} media markers for "
            f"{len(media)} media items")
    return parts, media


def build_chunks_mrope(prompt: str, media: list, tokenizer, mp,
                       grids: list, add_special: bool = True):
    """The Qwen2-VL variant: every chunk carries [3, n] (t, y, x) position
    streams, an image's grid compressing the position space (the
    published M-RoPE scheme); grids[i] = (h_tokens, w_tokens), the
    fallback where the tower records no native grid. Returns (flat_ids,
    chunks, mrope_delta): chunks ("tokens", ids, pos3) / ("embed", emb,
    dummies, pos3), decode positions kv_pos + mrope_delta."""
    parts, media = _split_media(prompt, media)
    chunks = []
    flat: list[int] = []
    nxt = 0
    for i, part in enumerate(parts):
        ids = []
        if part:
            ids = tokenizer.encode(part, add_special=add_special and i == 0,
                                   parse_special=True)
        elif i == 0 and add_special and tokenizer.add_bos \
                and tokenizer.bos_id is not None:
            ids = [tokenizer.bos_id]
        if ids:
            n = len(ids)
            pos3 = np.tile(np.arange(nxt, nxt + n, dtype=np.int32), (3, 1))
            chunks.append(("tokens", ids, pos3))
            flat.extend(ids)
            nxt += n
        if i < len(media):
            kind, data = media[i]
            emb, h = (mp.encode_audio(data) if kind == "audio"
                      else mp.encode(data))
            n = emb.shape[0]
            g = (getattr(mp, "image_grid", lambda _h: None)(h)
                 if kind == "image" else None)
            gh, gw = g if g else (grids[i] if i < len(grids) else (1, n))
            pos3 = np.zeros((3, n), np.int32)
            idx = np.arange(n)
            pos3[0] = nxt                      # temporal
            pos3[1] = nxt + idx // max(gw, 1)  # height
            pos3[2] = nxt + idx % max(gw, 1)   # width
            dummies = mp.dummy_tokens(h, n)
            chunks.append(("embed", emb, dummies, pos3))
            flat.extend(dummies)
            nxt += max(1, gh, gw)
    return flat, chunks, nxt - len(flat)


def build_chunks(prompt: str, media: list, tokenizer, mp,
                 add_special: bool = True):
    """Split the templated prompt on its markers and interleave the media
    embedding chunks. media: ("image"|"audio", bytes) pairs (or bare image
    bytes). Returns (flat_ids, chunks): ("tokens", ids) | ("embed", emb,
    dummies)."""
    parts, media = _split_media(prompt, media)
    chunks = []
    flat: list[int] = []
    for i, part in enumerate(parts):
        if part:
            ids = tokenizer.encode(part, add_special=add_special and i == 0,
                                   parse_special=True)
            if ids:
                chunks.append(("tokens", ids))
                flat.extend(ids)
        elif i == 0 and add_special and tokenizer.add_bos \
                and tokenizer.bos_id is not None:
            chunks.append(("tokens", [tokenizer.bos_id]))
            flat.append(tokenizer.bos_id)
        if i < len(media):
            kind, data = media[i]
            if kind == "audio":
                emb, h = mp.encode_audio(data)
            elif getattr(mp, "minicpmv_version", 0) > 0:
                _tiled_chunks(data, tokenizer, mp, chunks, flat, "minicpmv")
                continue
            elif getattr(mp, "is_llama4", False):
                _tiled_chunks(data, tokenizer, mp, chunks, flat, "llama4")
                continue
            else:
                emb, h = mp.encode(data)
            dummies = mp.dummy_tokens(h, emb.shape[0])
            chunks.append(("embed", emb, dummies))
            flat.extend(dummies)
    return flat, chunks


def _tiled_chunks(data: bytes, tokenizer, mp, chunks: list, flat: list,
                  family: str) -> None:
    """Compose a tiled scaffold in place.
    llama4 (httpserver.hpp:5846-5900):
      <|image_start|> t <|tile_x_separator|> t ... <|tile_y_separator|>
      (a row at a time) ... <|image|> overview <|image_end|>
    minicpmv (httpserver.hpp:5768-5846):
      2.5:  <image>ov</image><slice><image>t</image>...\\n...</slice>
      2.6+: <image>ov</image><slice>t</slice><slice>t</slice>\\n..."""

    def text(sv):
        ids = tokenizer.encode(sv, add_special=False, parse_special=True)
        if ids:
            chunks.append(("tokens", ids))
            flat.extend(ids)

    def embed(emb, salt):
        dummies = mp.dummy_tokens(fnv1a_64(data + salt), emb.shape[0])
        chunks.append(("embed", emb, dummies))
        flat.extend(dummies)

    if family == "llama4":
        embs, (gx, gy), _h = mp.encode_tiled_llama4(data)
        text("<|image_start|>")
        if gx and gy:
            for y in range(gy):
                for x in range(gx):
                    embed(embs[y * gx + x], b"/t%d" % (y * gx + x))
                    if x != gx - 1:
                        text("<|tile_x_separator|>")
                text("<|tile_y_separator|>")
        text("<|image|>")
        embed(embs[-1], b"/ov")
        text("<|image_end|>")
        return
    version = mp.minicpmv_version
    embs, (gx, gy), _h = mp.encode_sliced(data)
    text("<image>")
    embed(embs[0], b"/ov")
    text("</image>")
    if gx and gy and len(embs) > 1:
        ifmt, ofmt = (("<image>", "</image>") if version < 3
                      else ("<slice>", "</slice>"))
        if version < 3:
            text("<slice>")
        for y in range(gy):
            for x in range(gx):
                text(ifmt)
                embed(embs[1 + y * gx + x], b"/t%d" % (y * gx + x))
                text(ofmt)
            if y != gy - 1:
                text("\n")
        if version < 3:
            text("</slice>")
