"""Device-resident soft block-FEC decode (`liquid_dsp_tpu/fec/device.py`).

A streaming receiver that already holds corrected payload symbols on the
card decodes them there:

    symbols [..., nsym] complex
      -> exact max-log LLRs (modem.demodulate_soft)
      -> the bit-level deinterleave as one static-index gather (the
         interleaver's swap cascade is a fixed bit permutation for a given
         length, found once on the host by pushing an index ramp through
         deinterleave_soft)
      -> [..., ncw, n] x [n, 2^k] codebook correlation + argmax
         (`_scores_argmax`: the hand-written `codebook_argmax` kernel for
         codebooks of K >= 1024 words)
      -> k-bit message indices [..., ncw] int32

and `device_packet_finish` packs the message bits into bytes and checks
the CRC on the card too.  The soft max-correlation decode is the
reference's own soft criterion (fecsoft_* minimum soft distance).

The decoders are ``nn.Module``s: their constants (codebook, permutation,
constellation, byte-pack and CRC matrices) are buffers that follow
``.to(device)``, and a call runs where its input lies.
`packetizer2_soft_decoder` decodes the two-stage flexframe header (a
hamming84 codebook, then SECDED syndromes) the same way.  The
convolutional decoders (`conv_soft_decoder`, `conv_packet_soft_decoder`,
`qpacket_conv_soft_decoder`) depuncture by a static scatter and run the
hand-written `viterbi_acs` kernel on the card; they raise ValueError for
a configuration that is not one conv stage plus 'none' (the flexframe
and GMSK receivers take it as "not a conv config") and for v615, which
stays a host decode.

Reference analogs: src/fec/src/fec.c soft decode dispatch,
qpacketmodem_decode_soft src/framing/src/qpacketmodem.c:297-316.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..ops.kernels.codebook_argmax import codebook_argmax
from ..ops.kernels.viterbi_acs import viterbi_acs
from .block import _GCOLS, _SECDED, _code_matrices, _secded_cols
from .conv import (_parse, _trellis, conv_depuncture_index,
                   conv_get_enc_msg_length)
from .crc import crc_generate_key, crc_sizeof_key, crc_validate_message
from .dispatch import CONV_SCHEMES, fec_get_enc_msg_length
from .interleave import deinterleave_soft
from .packetizer import _plan, packetizer_compute_enc_msg_len

__all__ = ["qpacket_soft_decoder", "packetizer_soft_decoder",
           "block_codebook", "conv_soft_decoder", "conv_packet_soft_decoder",
           "qpacket_conv_soft_decoder", "packetizer2_soft_decoder",
           "device_packet_finish"]


def _on(x, like: torch.Tensor) -> torch.Tensor:
    """x as a tensor on `like`'s device: numpy is copied there, a tensor
    elsewhere raises (the decoders never move data on their own)."""
    if not torch.is_tensor(x):
        return torch.as_tensor(np.asarray(x), device=like.device)
    if x.device != like.device:
        raise ValueError(f"input on {x.device}, decoder buffers on "
                         f"{like.device}: move the decoder with .to()")
    return x


def _scores_argmax(cw: torch.Tensor, bip: torch.Tensor) -> torch.Tensor:
    """argmax over the codebook-correlation scores, [..., n] -> [...] int32.

    Codebooks of K >= 1024 words (golay2412, hamming1511) go through
    `codebook_argmax`: its kernel on a CUDA tensor, its plain version on
    the CPU.  Smaller ones take einsum + argmax, which the JAX package
    also computes outside any Pallas kernel."""
    if bip.shape[1] >= 1024:
        return codebook_argmax(cw.contiguous(), bip)
    scores = torch.einsum("...cn,nm->...cm", cw, bip)
    return torch.argmax(scores, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=16)
def block_codebook(scheme: str):
    """(bipolar codebook [n, 2^k] float32, n, k) for a block scheme:
    bip[:, m] = 2*G(m) - 1 where G(m) is message m's codeword."""
    n, k, _ = _GCOLS[scheme]
    G, _, _ = _code_matrices(scheme)
    msgs = ((np.arange(1 << k)[:, None] >>
             np.arange(k - 1, -1, -1)) & 1).astype(np.uint8)
    C = (msgs @ G) % 2
    return np.ascontiguousarray(2.0 * C.T - 1.0, np.float32), n, k


@functools.lru_cache(maxsize=16)
def _deint_perm(enc_len: int) -> np.ndarray:
    """Bit-level deinterleave permutation for an enc_len-byte packet:
    out_bit[i] = in_bit[perm[i]]."""
    ramp = np.arange(8 * enc_len, dtype=np.float32)
    return np.asarray(deinterleave_soft(ramp), np.float32).astype(np.int32)


def _golay_pack(msgs: np.ndarray, dec_len: int) -> np.ndarray:
    """Pack 12-bit message indices into bytes, two messages -> 3 bytes
    (the golay byte layout of fec/block.py); msgs [..., ncw]."""
    full, rem = divmod(dec_len, 3)
    m0 = msgs[..., 0:2 * full:2]
    m1 = msgs[..., 1:2 * full:2]
    out = np.zeros(msgs.shape[:-1] + (dec_len,), np.uint8)
    out[..., 0:3 * full:3] = (m0 >> 4) & 0xFF
    out[..., 1:3 * full:3] = ((m0 & 0x0F) << 4) | ((m1 >> 8) & 0x0F)
    out[..., 2:3 * full:3] = m1 & 0xFF
    for i in range(rem):
        out[..., 3 * full + i] = msgs[..., 2 * full + i] & 0xFF
    return out


def _pack_msgs(msgs: np.ndarray, fec1: str, k: int, ncw: int,
               dec_len: int) -> np.ndarray:
    """Host byte packing of decoded message indices (block-code path);
    shared by the host finish and the bit-relabel discovery of
    device_packet_finish."""
    if fec1 == "golay2412":
        return _golay_pack(msgs, dec_len)
    bits = ((msgs[..., None] >>
             np.arange(k - 1, -1, -1)) & 1).astype(np.uint8)
    bits = bits.reshape(msgs.shape[:-1] + (ncw * k,))[..., :8 * dec_len]
    return np.packbits(bits, axis=-1)[..., :dec_len]


def _num_codewords(fec1: str, k: int, dec_len: int) -> int:
    if fec1 == "golay2412":
        return 2 * (dec_len // 3) + dec_len % 3
    return -(-(8 * dec_len) // k)


class _BlockSoftDecoder(nn.Module):
    """llr [..., >= 8*enc_len] (positive = bit 1) -> msgs [..., ncw] int32;
    with a constellation, symbols [..., nsym] complex -> msgs."""

    def __init__(self, perm, bip, ncw: int, n: int, table=None):
        super().__init__()
        # copies: a buffer never aliases a cached numpy array
        self.register_buffer(
            "perm", torch.as_tensor(perm, dtype=torch.int64).clone())
        self.register_buffer(
            "bip", torch.as_tensor(bip, dtype=torch.float32).clone())
        self.register_buffer("table", None if table is None else torch.tensor(
            np.asarray(table, np.complex64)))
        self.ncw, self.n = ncw, n

    def forward(self, x):
        return _scores_argmax(self.soft_bits(x), self.bip)

    def soft_bits(self, x):
        """The deinterleaved codeword soft bits [..., ncw, n] that the
        codebook correlation scores."""
        if self.table is not None:
            from ..modem.linear import demodulate_soft
            llr = demodulate_soft(self.table, _on(x, self.table))
            x = llr.reshape(llr.shape[:-2] + (-1,))
        flat = _on(x, self.perm).to(torch.float32)
        need = self.perm.shape[0]
        if flat.shape[-1] < need:
            flat = torch.nn.functional.pad(flat, (0, need - flat.shape[-1]))
        deint = flat[..., :need][..., self.perm]
        # 8*enc_len may exceed ncw*n by the last byte's pad bits
        return deint[..., :self.ncw * self.n].reshape(
            deint.shape[:-1] + (self.ncw, self.n))


def packetizer_soft_decoder(payload_len: int, crc: str = "crc24",
                            fec0: str = "none", fec1: str = "golay2412"):
    """(device_fn, finish) for a packetizer configuration whose outer code
    is a block scheme and inner code is none.

    device_fn(llr [..., >= 8*enc_len], positive = bit 1) -> msgs [..., ncw]
      int32, a module that runs where its buffers are (``.to(device)``);
    finish(msgs numpy [..., ncw]) -> (payload [..., payload_len] uint8,
      crc_ok [...] bool): host byte packing + CRC.
    """
    if fec0 != "none":
        raise ValueError("device decoder supports fec0='none' "
                         "(frame64/flexframe default payload shape)")
    if fec1 not in _GCOLS:
        raise ValueError(f"outer scheme {fec1!r} is not a block code")
    if _GCOLS[fec1][1] > 16:
        raise ValueError(f"{fec1!r} codebook too large for the matmul "
                         "decoder (k > 16)")
    dec_len = payload_len + crc_sizeof_key(crc)
    enc_len = fec_get_enc_msg_length(fec1, dec_len)
    assert enc_len == packetizer_compute_enc_msg_len(
        payload_len, crc, fec0, fec1)
    bip, n, k = block_codebook(fec1)
    ncw = _num_codewords(fec1, k, dec_len)
    device_fn = _BlockSoftDecoder(_deint_perm(enc_len), bip, ncw, n)

    def finish(msgs):
        return _crc_rows(_pack_msgs(np.asarray(msgs), fec1, k, ncw, dec_len),
                         payload_len, crc)

    return device_fn, finish


def qpacket_soft_decoder(payload_len: int, crc: str = "crc24",
                         fec0: str = "none", fec1: str = "golay2412",
                         ms: str = "qpsk"):
    """(device_fn, finish) for a qpacketmodem configuration whose outer
    code is a block scheme and inner code is none (the frame64 payload):
    `packetizer_soft_decoder` with the modem's exact max-log soft
    demodulator in front.  device_fn(symbols [..., nsym] complex) ->
    msgs [..., ncw] int32."""
    from ..modem.linear import constellation
    llr_fn, finish = packetizer_soft_decoder(payload_len, crc, fec0, fec1)
    device_fn = _BlockSoftDecoder(llr_fn.perm, llr_fn.bip, llr_fn.ncw,
                                  llr_fn.n, table=constellation(ms))
    return device_fn, finish


def _conv_scheme(fec0: str, fec1: str) -> str:
    """The one convolutional stage of a (fec0, fec1) pair whose other
    stage is 'none'; ValueError otherwise, as the JAX package's check
    (`liquid_dsp_tpu/fec/device.py:284-289`), which the flexframe and
    GMSK receivers take as "not a conv config"."""
    schemes = {fec0, fec1}
    conv = [s for s in schemes if s in CONV_SCHEMES]
    if len(conv) != 1 or (schemes - set(conv)) != {"none"}:
        raise ValueError("conv packet decoder needs exactly one conv "
                         f"stage and one 'none', got ({fec0!r}, {fec1!r})")
    return conv[0]


class _ConvSoftDecoder(nn.Module):
    """llr [..., >= n_kept] (positive = bit 1) -> bits [..., 8*dec_len]
    int32: the static depuncture scatter (erasures = zero metric), then
    the ACS recurrence and traceback of `viterbi_acs` (its kernel on a
    CUDA tensor, its plain version on the CPU)."""

    def __init__(self, scheme: str, dec_len: int):
        super().__init__()
        K, polys, _ = _parse(scheme)
        out, _ = _trellis(K, tuple(polys))
        self.r = len(polys)
        self.nbits_in = 8 * dec_len + K - 1
        self.nout = 8 * dec_len
        keep = conv_depuncture_index(scheme, dec_len)
        self.register_buffer("keep_idx", torch.from_numpy(keep))
        self.register_buffer("exp", torch.from_numpy(
            2.0 * out.astype(np.float32) - 1.0))              # [ns, 2, r]

    def obs(self, llr):
        """The depunctured metrics [M, T, r] (leading axes flattened) that
        `viterbi_acs` decodes."""
        llr = _on(llr, self.exp).to(torch.float32)
        n_kept = self.keep_idx.shape[0]
        flat = torch.zeros(llr.shape[:-1] + (self.nbits_in * self.r,),
                           dtype=torch.float32, device=llr.device)
        flat[..., self.keep_idx] = llr[..., :n_kept]
        return flat.reshape(-1, self.nbits_in, self.r)

    def forward(self, llr):
        bits = viterbi_acs(self.obs(llr), self.exp, self.nout)
        return bits.reshape(llr.shape[:-1] + (self.nout,))


def conv_soft_decoder(scheme: str, dec_len: int):
    """Batched soft Viterbi for a convolutional scheme: returns
    (device_fn, enc_len) with device_fn(llr [..., >= 8*enc_len] float,
    positive = bit 1) -> bits [..., 8*dec_len] int32, a module that runs
    where its buffers are (``.to(device)``).

    The depuncture is a static scatter (erasures are zero metrics); the
    add-compare-select steps and the traceback are the `viterbi_acs`
    kernel on the card (one warp per codeword), its plain version
    on the CPU; both keep the JAX package's device rules (the -1e9 start,
    the strict compare, the max subtracted each step).  v615 raises
    ValueError: its 16384 states per step stay a host decode
    (`fec/conv.py:conv_decode`), as in the JAX package.  Reference
    analog: fec_conv.c:225-266 (libfec's Viterbi)."""
    K, _, _ = _parse(scheme)
    if K > 9:
        raise ValueError(
            f"{scheme!r}: 2^{K - 1} = {1 << (K - 1)} states per ACS step "
            "is host-only territory (see API_PARITY.md)")
    return (_ConvSoftDecoder(scheme, dec_len),
            conv_get_enc_msg_length(scheme, dec_len))


def _crc_rows(buf: np.ndarray, payload_len: int, crc: str):
    """(payload [..., payload_len], crc_ok [...]) of decoded packets
    buf [..., dec_len] uint8: the host CRC check per row."""
    nk = crc_sizeof_key(crc)
    flat = buf.reshape(-1, buf.shape[-1])
    ok = np.zeros(flat.shape[0], bool)
    for r in range(flat.shape[0]):
        key = 0
        for b in flat[r, payload_len:payload_len + nk]:
            key = (key << 8) | int(b)
        ok[r] = crc_validate_message(crc, flat[r, :payload_len], key)
    return buf[..., :payload_len], ok.reshape(buf.shape[:-1])


class _ConvPacketDecoder(nn.Module):
    """llr [..., >= 8*enc_len] -> bits [..., 8*dec_len] int32; with a
    constellation, symbols [..., nsym] complex -> bits."""

    def __init__(self, scheme: str, dec_len: int, enc_len: int, table=None):
        super().__init__()
        self.vit, vit_enc = conv_soft_decoder(scheme, dec_len)
        assert vit_enc == enc_len
        self.register_buffer("perm", torch.from_numpy(
            _deint_perm(enc_len).astype(np.int64)))
        self.register_buffer("table", None if table is None else torch.tensor(
            np.asarray(table, np.complex64)))

    def llr(self, x):
        """The deinterleaved encoded-bit metrics [..., 8*enc_len]."""
        if self.table is not None:
            from ..modem.linear import demodulate_soft
            llr = demodulate_soft(self.table, _on(x, self.table))
            x = llr.reshape(llr.shape[:-2] + (-1,))
        flat = _on(x, self.perm).to(torch.float32)
        need = self.perm.shape[0]
        if flat.shape[-1] < need:
            flat = torch.nn.functional.pad(flat, (0, need - flat.shape[-1]))
        return flat[..., :need][..., self.perm]

    def forward(self, x):
        return self.vit(self.llr(x))


def _conv_packet(payload_len, crc, fec0, fec1, table=None):
    scheme = _conv_scheme(fec0, fec1)
    dec_len = payload_len + crc_sizeof_key(crc)
    enc_len = packetizer_compute_enc_msg_len(payload_len, crc, fec0, fec1)
    device_fn = _ConvPacketDecoder(scheme, dec_len, enc_len, table)

    def finish(bits):
        buf = np.packbits(np.asarray(bits, np.uint8), axis=-1)[..., :dec_len]
        return _crc_rows(buf, payload_len, crc)

    return device_fn, finish


def conv_packet_soft_decoder(payload_len: int, crc: str = "crc32",
                             fec0: str = "v27", fec1: str = "none"):
    """(device_fn, finish) for a packetizer configuration whose coding is
    ONE convolutional stage (the other 'none'): encode reduces to
    interleave4(conv_encode(buf)) either way, so the device path is the
    static deinterleave gather and the batched soft Viterbi.

    device_fn(llr [..., >= 8*enc_len]) -> bits [..., 8*dec_len] int32, a
      module (``.to(device)``);
    finish(bits numpy) -> (payload [..., payload_len] uint8, crc_ok).
    ValueError for any other configuration, and for v615."""
    return _conv_packet(payload_len, crc, fec0, fec1)


def qpacket_conv_soft_decoder(payload_len: int, crc: str = "crc32",
                              fec0: str = "v27", fec1: str = "none",
                              ms: str = "qpsk"):
    """`conv_packet_soft_decoder` with the modem's exact max-log soft
    demodulator in front: device_fn(symbols [..., nsym] complex) ->
    bits [..., 8*dec_len] int32."""
    from ..modem.linear import constellation
    return _conv_packet(payload_len, crc, fec0, fec1, constellation(ms))


class _Packetizer2SoftDecoder(nn.Module):
    """llr [..., >= 8*enc_len] (positive = bit 1) -> (buf bytes
    [..., payload_len] int32, crc_ok [...] bool); see
    `packetizer2_soft_decoder`."""

    def __init__(self, payload_len, crc, fec0, fec1):
        super().__init__()
        _, stages = _plan(payload_len, crc, fec0, fec1)
        (fs0, d0, e0, _), (fs1, d1, e1, _) = stages
        assert fs0 == fec0 and fs1 == fec1 and d1 == e0
        bip, n1, k1 = block_codebook(fec1)
        self.ncw, self.n1, self.k1, self.d1 = -(-(8 * d1) // k1), n1, k1, d1
        p, m, _ = _SECDED[fec0]
        cols, table_pos = _secded_cols(fec0)
        nbytes = m // 8
        nblk = -(-d0 // nbytes)
        self.p, self.m, self.nblk = p, m, nblk
        # static layout: deinterleaved stage-0 bit index for each block's
        # parity byte and data bytes (-1 = zero pad in the final block).
        # The parity byte carries p <= 8 syndrome bits in its LOW bits
        # (fec_secded2216.c packs v[0] & 0x3f), i.e. byte bits (8-p)..7.
        lay_par = np.zeros((nblk, 8), np.int64)
        lay_dat = np.full((nblk, m), -1, np.int64)
        pos_e = pos_d = 0
        sel = []
        for b in range(nblk):
            take = min(nbytes, d0 - pos_d)
            lay_par[b] = 8 * pos_e + np.arange(8)
            for j in range(take):
                lay_dat[b, 8 * j: 8 * j + 8] = \
                    8 * (pos_e + 1 + j) + np.arange(8)
            # corrected data bits -> buf bits, skipping final-block pads
            sel.extend(range(b * m, b * m + 8 * take))
            pos_e += 1 + take
            pos_d += take
        flip = np.zeros((1 << p, m), np.float32)
        for s in range(1, 1 << p):
            if 0 <= table_pos[s] < m:
                flip[s, table_pos[s]] = 1.0
        consts = {
            "perm_out": _deint_perm(e1), "perm_in": _deint_perm(e0),
            "bip": bip,
            # gather maps into the deinterleaved bit vector; index 8*e0
            # is an appended zero slot for the pads
            "gp": np.where(lay_par >= 0, lay_par, 8 * e0)[:, 8 - p:],
            "gd": np.where(lay_dat >= 0, lay_dat, 8 * e0),
            "cols": ((cols[:, None] >> (p - 1 - np.arange(p))[None, :]) & 1
                     ).astype(np.float32),                       # [m, p]
            "flip": flip,
            "pow2": (1 << (p - 1 - np.arange(p))).astype(np.float32),
            "sel": np.asarray(sel, np.int64),
            "shifts": np.arange(k1 - 1, -1, -1, dtype=np.int64)}
        for key, v in consts.items():
            v = np.asarray(v)
            self.register_buffer(key, torch.from_numpy(np.ascontiguousarray(
                v, np.int64 if v.dtype.kind in "iu" else np.float32)))
        self.finish = device_packet_finish(payload_len, crc, "none", "none")

    def forward(self, llr):
        flat = _on(llr, self.bip).to(torch.float32)
        need = self.perm_out.shape[0]
        if flat.shape[-1] < need:
            flat = torch.nn.functional.pad(flat, (0, need - flat.shape[-1]))
        # outer stage: bit deinterleave, codebook correlation + argmax
        deint = flat[..., :need][..., self.perm_out]
        cw = deint[..., :self.ncw * self.n1].reshape(
            deint.shape[:-1] + (self.ncw, self.n1))
        msgs = _scores_argmax(cw, self.bip)
        bits = (msgs.to(torch.int64)[..., None] >> self.shifts) & 1
        bits = bits.reshape(msgs.shape[:-1] + (self.ncw * self.k1,))
        bits = bits[..., :8 * self.d1].to(torch.float32)
        # inner stage: byte deinterleave (a bit relabel) + zero pad slot,
        # then per block the SECDED syndrome as a GF(2) matmul (sums of at
        # most m 0/1 terms: exact in float32), its value, the one-hot
        # flip row and the mod-2 correction
        deint0 = torch.nn.functional.pad(bits[..., self.perm_in], (0, 1))
        par_bits = deint0[..., self.gp]                  # [.., nblk, p]
        dat_bits = deint0[..., self.gd]                  # [.., nblk, m]
        synd = torch.remainder(torch.einsum(
            "...bm,mp->...bp", dat_bits, self.cols) + par_bits, 2.0)
        sval = torch.einsum("...bp,p->...b", synd, self.pow2).to(torch.int32)
        onehot = (sval[..., None] == torch.arange(
            1 << self.p, device=sval.device)).to(torch.float32)
        flip = torch.einsum("...bs,sm->...bm", onehot, self.flip)
        fixed = torch.remainder(dat_bits + flip, 2.0)
        buf_bits = fixed.reshape(fixed.shape[:-2] + (self.nblk * self.m,))
        return self.finish(buf_bits[..., self.sel].to(torch.int32))


def packetizer2_soft_decoder(payload_len: int, crc: str = "crc32",
                             fec0: str = "secded7264",
                             fec1: str = "hamming84"):
    """TWO-stage block packetizer decode on the device: the flexframe
    HEADER configuration (crc32, secded7264, hamming84; reference
    flexframegen.c header encoder).  Returns a module
    decode_fn(llr [..., >= 8*enc_len], positive = bit 1) ->
    (buf_bytes [..., payload_len] int32, crc_ok [...] bool) whose tables
    are buffers (``.to(device)``):

      * outer stage (fec1): bit deinterleave (a static gather) + soft
        codebook correlation and argmax (`_scores_argmax`; the
        einsum for hamming84's 16 words, first index on ties);
      * inner stage (fec0 SECDED): byte deinterleave, per 72-bit block
        the syndrome by a GF(2) parity matmul of the data bits against
        the column matrix plus the received parity bits mod 2, the error
        position a one-hot row of a [2^p, m] flip table, the correction a
        mod-2 add (reference fec_secded7264.c decodes byte by byte);
      * byte pack + CRC: `device_packet_finish`."""
    if fec0 not in _SECDED:
        raise ValueError(f"fec0 {fec0!r} is not a SECDED scheme")
    if fec1 not in _GCOLS or _GCOLS[fec1][1] > 16:
        raise ValueError(f"fec1 {fec1!r} needs a small block codebook")
    return _Packetizer2SoftDecoder(payload_len, crc, fec0, fec1)


@functools.lru_cache(maxsize=32)
def _crc_affine(scheme: str, payload_len: int):
    """CRC keys are GF(2)-affine in the message bits for a fixed message
    length: key_bits(m) = M^T bits(m) xor key_bits(0).  The columns come
    from bit-impulse messages through the byte-exact host CRC.

    Returns (M [8*payload_len, width] uint8, cbits [width] uint8)."""
    width = 8 * crc_sizeof_key(scheme)

    def keybits(msg):
        kk = crc_generate_key(scheme, msg)
        return np.array([(kk >> (width - 1 - w)) & 1
                         for w in range(width)], np.uint8)

    cbits = keybits(np.zeros(payload_len, np.uint8))
    M = np.zeros((8 * payload_len, width), np.uint8)
    for i in range(8 * payload_len):
        msg = np.zeros(payload_len, np.uint8)
        msg[i >> 3] = 0x80 >> (i & 7)
        M[i] = keybits(msg) ^ cbits
    return M, cbits


class _PacketFinish(nn.Module):
    """dec -> (payload [..., payload_len] int32 bytes, crc_ok [...] bool)
    on the card: byte packing and the CRC parity are matmuls of 0/1 bits
    in float64, so their integer sums are exact whatever the float32
    matmul settings (TF32) are."""

    def __init__(self, W, sumw, P, cbits, crc: str, k: int, nsrc: int):
        super().__init__()
        self.register_buffer("W", torch.from_numpy(W))
        self.register_buffer("sumw", torch.from_numpy(sumw))
        self.register_buffer("P", None if P is None else torch.from_numpy(P))
        self.register_buffer("cbits", None if cbits is None
                             else torch.from_numpy(cbits))
        self.crc, self.k, self.nsrc = crc, k, nsrc

    def forward(self, dec):
        dec = _on(dec, self.W)
        if self.k:
            sh = torch.arange(self.k - 1, -1, -1, device=dec.device)
            bits = (dec.to(torch.int64)[..., None] >> sh) & 1
            src = bits.reshape(dec.shape[:-1] + (self.nsrc,))
        else:
            src = dec[..., :self.nsrc]
        src = src.to(torch.float64)
        payload = torch.matmul(src, self.W).round().to(torch.int32)
        if self.crc == "none":
            ok = torch.ones(dec.shape[:-1], dtype=torch.bool,
                            device=dec.device)
        elif self.crc == "checksum":
            ok = torch.remainder(torch.matmul(src, self.sumw), 256.0) == 0
        else:
            par = torch.matmul(src, self.P) + self.cbits
            ok = (torch.remainder(par, 2.0) == 0).all(dim=-1)
        return payload, ok


def device_packet_finish(payload_len: int, crc: str = "crc24",
                         fec0: str = "none", fec1: str = "golay2412"):
    """Byte pack + CRC validation of a decoded packet on the card: the
    device counterpart of the host `finish` functions above.

    Input follows the decoder family:
      * block configs (fec0='none', fec1 a block code): msgs [..., ncw]
        int32 as produced by packetizer_soft_decoder's device_fn;
      * uncoded or conv configs (one conv stage + 'none'): bits
        [..., 8*dec_len].

    Returns a module finish_fn(dec) -> (payload [..., payload_len] int32
    bytes, crc_ok [...] bool).  Byte packing is a 0/1-weight matmul (bit
    -> byte place value) and the CRC its GF(2)-affine parity matmul
    (_crc_affine) reduced mod 2; the 'checksum' scheme is integer-affine:
    byte-sum + key must vanish mod 256.
    """
    if crc not in ("none", "checksum", "crc8", "crc16", "crc24", "crc32"):
        raise ValueError(f"unknown crc scheme {crc!r}")
    dec_len = payload_len + crc_sizeof_key(crc)
    width = 8 * crc_sizeof_key(crc) if crc.startswith("crc") else 0
    schemes = {fec0, fec1}
    if fec0 == "none" and fec1 in _GCOLS:
        if _GCOLS[fec1][1] > 16:
            raise ValueError(f"{fec1!r} codebook too large (k > 16)")
        _, n, k = block_codebook(fec1)
        ncw = _num_codewords(fec1, k, dec_len)
        nsrc = ncw * k
        # impulse-response discovery: which buf bit each msg bit feeds
        relabel = np.full(8 * dec_len, -1, np.int64)
        for cpos in range(ncw):
            for j in range(k):
                m = np.zeros(ncw, np.int64)
                m[cpos] = 1 << (k - 1 - j)
                nz = np.nonzero(np.unpackbits(
                    _pack_msgs(m, fec1, k, ncw, dec_len)))[0]
                assert len(nz) <= 1, "byte packing must be a bit relabel"
                if len(nz):
                    relabel[nz[0]] = cpos * k + j
    elif schemes == {"none"} or (
            len(schemes) == 2 and "none" in schemes
            and not schemes - {"none"} - set(CONV_SCHEMES)):
        k = 0
        nsrc = 8 * dec_len
        relabel = np.arange(8 * dec_len, dtype=np.int64)
    else:
        raise ValueError(f"unsupported finish config ({fec0!r}, {fec1!r})")

    Wall = np.zeros((nsrc, dec_len), np.float64)
    for q in range(8 * dec_len):
        if relabel[q] >= 0:
            Wall[relabel[q], q >> 3] += float(0x80 >> (q & 7))
    P = cbits = None
    if width:
        M, cb = _crc_affine(crc, payload_len)
        Pb = np.zeros((nsrc, width), np.uint8)
        for i in range(8 * payload_len):
            if relabel[i] >= 0:
                Pb[relabel[i]] ^= M[i]
        for w in range(width):
            s = relabel[8 * payload_len + w]
            if s >= 0:
                Pb[s, w] ^= 1
        P, cbits = Pb.astype(np.float64), cb.astype(np.float64)
    return _PacketFinish(np.ascontiguousarray(Wall[:, :payload_len]),
                         Wall.sum(axis=1), P, cbits, crc, k, nsrc)
