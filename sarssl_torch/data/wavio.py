"""Audio IO without soundfile: RIFF/WAVE parsing with header-only probing
and ranged reads, plus FLAC STREAMINFO probing (the port's own copy of
``sarssl_tpu/data/wavio.py``, whose package imports JAX).

The real-recording corpora are hours-long multichannel files; building item
tables must not decode them (the reference uses ``soundfile.info`` for the
same reason, utils_real_micsig.py). ``audio_info`` reads only the header;
``read_audio`` seeks straight to the requested frame range.

Writes float32 WAVs so the trees are bit-compatible with what the
reference's soundfile.write produces for float input.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile


def write_wav(path: str, data: np.ndarray, fs: int):
    wavfile.write(path, fs, data.astype(np.float32))


@dataclass(frozen=True)
class AudioInfo:
    frames: int
    fs: int
    channels: int
    sampwidth: int          # bytes per sample
    audio_format: int       # 1=PCM int, 3=IEEE float (wav); 0 for flac
    data_offset: int        # byte offset of sample data (wav only)

    @property
    def duration(self) -> float:
        return self.frames / self.fs


def _wav_info(f) -> AudioInfo:
    head = f.read(12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk found")
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            chunk = f.read(size + (size & 1))
            audio_format, nch, fs, _, _, bits = struct.unpack(
                "<HHIIHH", chunk[:16])
            if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_format = struct.unpack("<H", chunk[24:26])[0]
            fmt = (audio_format, nch, fs, bits // 8)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            audio_format, nch, fs, sampwidth = fmt
            offset = f.tell()
            frames = size // (nch * sampwidth) if size else 0
            # streamed writers leave size 0/0xFFFFFFFF: fall back to file size
            if size in (0, 0xFFFFFFFF):
                end = f.seek(0, os.SEEK_END)
                frames = (end - offset) // (nch * sampwidth)
            return AudioInfo(frames, fs, nch, sampwidth, audio_format, offset)
        else:
            f.seek(size + (size & 1), os.SEEK_CUR)


def _flac_info(f) -> AudioInfo:
    if f.read(4) != b"fLaC":
        raise ValueError("not a FLAC file")
    while True:
        hdr = f.read(4)
        if len(hdr) < 4:
            raise ValueError("no STREAMINFO block")
        last = bool(hdr[0] & 0x80)
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        if btype == 0:  # STREAMINFO
            blk = f.read(size)
            fs = (blk[10] << 12) | (blk[11] << 4) | (blk[12] >> 4)
            nch = ((blk[12] >> 1) & 0x07) + 1
            bits = (((blk[12] & 1) << 4) | (blk[13] >> 4)) + 1
            frames = ((blk[13] & 0x0F) << 32) | int.from_bytes(
                blk[14:18], "big")
            return AudioInfo(frames, fs, nch, (bits + 7) // 8, 0, -1)
        f.seek(size, os.SEEK_CUR)
        if last:
            raise ValueError("no STREAMINFO block")


def audio_info(path: str) -> AudioInfo:
    """Header-only probe: frames / fs / channels without decoding."""
    with open(path, "rb") as f:
        magic = f.read(4)
        f.seek(0)
        if magic == b"fLaC":
            return _flac_info(f)
        return _wav_info(f)


_WAV_DTYPES = {(1, 2): np.int16, (1, 4): np.int32, (1, 1): np.uint8,
               (3, 4): np.float32, (3, 8): np.float64}


def _to_float32(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def read_audio(path: str, start: Optional[int] = None,
               stop: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read (a frame range of) an audio file -> (float32 (n, nch), fs).

    WAV ranges are served by seeking directly to the samples; FLAC needs a
    decoder and falls back to soundfile when available.
    """
    info = audio_info(path)
    if info.data_offset < 0:  # FLAC
        try:
            import soundfile
        except ImportError as e:
            raise RuntimeError(
                f"{path}: FLAC decoding needs the optional soundfile "
                f"package; re-encode to wav or install it") from e
        data, fs = soundfile.read(path, start=start or 0, stop=stop,
                                  dtype="float32", always_2d=True)
        return data, fs
    dtype = _WAV_DTYPES.get((info.audio_format, info.sampwidth))
    if dtype is None:
        raise ValueError(f"{path}: unsupported wav format "
                         f"({info.audio_format}, {info.sampwidth * 8} bit)")
    start = 0 if start is None else max(0, int(start))
    stop = info.frames if stop is None else min(info.frames, int(stop))
    count = max(0, stop - start) * info.channels
    with open(path, "rb") as f:
        f.seek(info.data_offset + start * info.channels * info.sampwidth)
        data = np.fromfile(f, dtype=dtype, count=count)
    data = data.reshape(-1, info.channels)
    return _to_float32(data), info.fs


def read_wav(path: str):
    """Returns (data float32 (nsample, nch), fs)."""
    fs, data = wavfile.read(path)
    data = _to_float32(data)
    if data.ndim == 1:
        data = data[:, None]
    return data, fs
