"""MP3 decoding via the platform's mpg123 codec (ctypes, no build step;
a copy of llama_box_tpu/utils/mp3.py).

The reference accepts wav+mp3 `input_audio` (httpserver.hpp:1076-1078,
decoded by its vendored miniaudio/minimp3). This package binds the
system libmpg123 instead of vendoring a decoder: the library ships in the
serving image, the feed API needs no filesystem, and output is forced to
float32 so no intermediate precision is lost. When the library is absent
the caller gets a clear capability error (and the HTTP layer rejects the
format up front via `available()`).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_ENC_FLOAT_32 = 0x200
_MONO_STEREO = 3  # MPG123_MONO | MPG123_STEREO

_lock = threading.Lock()
_lib = None
_lib_err: str | None = None


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    try:
        lib = ctypes.CDLL("libmpg123.so.0")
    except OSError as exc:
        _lib_err = f"libmpg123 not found: {exc}"
        return None
    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t]
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_getformat.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_long),
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_int, ctypes.c_int]
    lib.mpg123_rates.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
        ctypes.POINTER(ctypes.c_size_t)]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def looks_like_mp3(data: bytes) -> bool:
    """ID3v2 tag or an MPEG audio frame sync at the head."""
    if data[:3] == b"ID3":
        return True
    return (len(data) > 1 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0
            and data[:4] != b"RIFF")


def decode_mp3(data: bytes) -> tuple[np.ndarray, int]:
    """MP3 bytes -> (mono float32 waveform, sample_rate)."""
    lib = _load()
    if lib is None:
        raise ValueError(
            f"mp3 input_audio needs the mpg123 codec ({_lib_err})")
    with _lock:
        err = ctypes.c_int(0)
        h = lib.mpg123_new(None, ctypes.byref(err))
        if not h:
            raise ValueError(f"mpg123_new failed ({err.value})")
        try:
            # force float32 output for every rate/channel combination
            lib.mpg123_format_none(h)
            rates = ctypes.POINTER(ctypes.c_long)()
            n_rates = ctypes.c_size_t(0)
            lib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n_rates))
            for i in range(n_rates.value):
                lib.mpg123_format(h, rates[i], _MONO_STEREO, _ENC_FLOAT_32)

            if lib.mpg123_open_feed(h) != _MPG123_OK:
                raise ValueError("mpg123_open_feed failed")
            if lib.mpg123_feed(h, data, len(data)) != _MPG123_OK:
                raise ValueError("mpg123_feed failed")

            rate = ctypes.c_long(0)
            ch = ctypes.c_int(0)
            enc = ctypes.c_int(0)
            out = (ctypes.c_char * 65536)()
            done = ctypes.c_size_t(0)
            chunks = []
            while True:
                ret = lib.mpg123_read(h, out, len(out), ctypes.byref(done))
                if done.value:
                    chunks.append(bytes(out[:done.value]))
                if ret == _MPG123_NEW_FORMAT:
                    lib.mpg123_getformat(h, ctypes.byref(rate),
                                         ctypes.byref(ch), ctypes.byref(enc))
                    continue
                if ret in (_MPG123_NEED_MORE, _MPG123_DONE):
                    break  # the whole stream was fed up front
                if ret != _MPG123_OK:
                    raise ValueError(f"mpg123 decode error {ret}")
            if not chunks or rate.value <= 0:
                raise ValueError("mp3 stream contained no decodable audio")
            pcm = np.frombuffer(b"".join(chunks), np.float32)
            if ch.value > 1:
                pcm = pcm.reshape(-1, ch.value).mean(axis=1)
            return pcm.astype(np.float32), int(rate.value)
        finally:
            lib.mpg123_delete(h)
