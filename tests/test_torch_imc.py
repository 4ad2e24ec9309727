"""``repro_torch.core.imc`` (device, array, ISA, energy) against the JAX
package, on the CPU.

The cases of ``tests/test_imc_device.py`` run on the port, and the same
numpy inputs go through both packages:

* exact: the material tables, ``noise_sigma``, ``bit_error_rate``,
  ``programming_energy_j``, ``dac_quantize``, ``adc_quantize``, every
  energy and cost report, the published tables, instruction encoding and
  decoding, ``compile_db_search``, the executor's traces, and ``READ_HV``
  (including its clamped start) on the reference's programmed bank;
* rtol 1e-5 / atol 1e-3: analog scores (``imc_mvm``,
  ``imc_mvm_reference`` and ``MVM_COMPUTE``) on the reference's
  programmed weights. The port's kernel takes each tile's partial as a
  chain of fused multiply-adds and the reference sums it in XLA's order,
  rounding ``code * lsb`` before the sum;
* the port's own write noise (a ``torch.Generator`` draw, not
  threefry) meets the reference's invariants: zero weights stay zero,
  ``noisy / weights`` has mean 1 and standard deviation
  ``noise_sigma``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.imc.array as ref_array
import repro.core.imc.device as ref_device
import repro.core.imc.energy as ref_energy
import repro.core.imc.isa as ref_isa
from repro.dist import sharding
from repro_torch.convert import imc_state_from_numpy
from repro_torch.core.imc import energy
from repro_torch.core.imc.array import (
    ArrayConfig,
    adc_quantize,
    dac_quantize,
    default_full_scale,
    imc_mvm,
    imc_mvm_reference,
    program_hvs,
)
from repro_torch.core.imc.device import (
    MATERIALS,
    SB2TE3_GST,
    TITE2_GST,
    DeviceConfig,
    apply_write_noise,
    bit_error_rate,
    noise_sigma,
    programming_energy_j,
)
from repro_torch.core.imc.energy import (
    DATASETS,
    DEFAULT_HW,
    PAPER_ENERGY,
    PAPER_TABLE2,
    PAPER_TABLE3,
    clustering_cost,
    db_search_cost,
)
from repro_torch.core.imc.isa import (
    Instruction,
    ISAExecutor,
    Opcode,
    compile_db_search,
    decode_instruction,
    encode_instruction,
)
from repro_torch.kernels.imc_mvm import imc_mvm_plain

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _no_global_mesh():
    sharding.set_mesh(None)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _levels(rng, shape, n=3):
    return rng.integers(-n, n + 1, shape).astype(np.int8)


def _ref_dev(cfg):
    return ref_device.DeviceConfig(**dataclasses.asdict(cfg))


def _ref_arr(cfg):
    return ref_array.ArrayConfig(**dataclasses.asdict(cfg))


# --------------------------------------------------------------------------
# device (tests/test_imc_device.py::TestDevice)
# --------------------------------------------------------------------------

class TestDevice:
    def test_material_table_s1(self):
        assert SB2TE3_GST.programming_energy_pj == pytest.approx(1.12)
        assert TITE2_GST.programming_energy_pj == pytest.approx(2.88)
        assert TITE2_GST.retention_hours_105c > SB2TE3_GST.retention_hours_105c

    def test_materials_equal_the_reference(self):
        assert MATERIALS.keys() == ref_device.MATERIALS.keys()
        for key, m in MATERIALS.items():
            assert dataclasses.asdict(m) == dataclasses.asdict(
                ref_device.MATERIALS[key])

    def test_ber_decreases_with_write_verify(self):
        bers = [bit_error_rate(DeviceConfig("tite2", 3, c)) for c in range(6)]
        assert all(bers[i] > bers[i + 1] for i in range(5))
        assert bers[0] > 0.08
        assert bers[5] < 0.08

    def test_ber_increases_with_bits_per_cell(self):
        for c in (0, 3):
            b = [bit_error_rate(DeviceConfig("tite2", n, c)) for n in (1, 2, 3)]
            assert b[0] < b[1] and b[0] < b[2]
            assert b[1] <= b[2] * 1.15

    def test_materials_error_ordering(self):
        assert noise_sigma(DeviceConfig("tite2", 3, 5)) < \
            noise_sigma(DeviceConfig("sb2te3", 3, 5))

    @pytest.mark.parametrize("material", ["tite2", "sb2te3"])
    @pytest.mark.parametrize("bits", [1, 2, 3, 4])
    def test_sigma_ber_and_energy_equal_the_reference(self, material, bits):
        for c in range(8):
            cfg = DeviceConfig(material, bits, c)
            ref = _ref_dev(cfg)
            assert noise_sigma(cfg) == ref_device.noise_sigma(ref)
            assert bit_error_rate(cfg) == ref_device.bit_error_rate(ref)
            assert programming_energy_j(cfg, 12345) == \
                ref_device.programming_energy_j(ref, 12345)

    def test_write_noise_is_multiplicative(self):
        w = torch.tensor([[0.0, 1.0, -3.0]])
        out = apply_write_noise(_gen(0), w, DeviceConfig("tite2", 3, 3))
        assert float(out[0, 0]) == 0.0  # zero weights stay zero
        assert out.shape == w.shape and out.dtype == torch.float32

    @pytest.mark.parametrize("cfg", [DeviceConfig("tite2", 3, 3),
                                     DeviceConfig("sb2te3", 3, 0),
                                     DeviceConfig("tite2", 1, 5)])
    def test_write_noise_statistics(self, cfg):
        """noisy / weights has mean 1 and std noise_sigma (500,000 draws:
        the mean's standard error is sigma / 707, the std's sigma / 1000),
        as the reference's draws have."""
        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.choice([-3, -1, 1, 3], (500, 1000)).astype(
            np.int8))
        ratio = (apply_write_noise(_gen(1), w, cfg) / w.float()).double()
        sigma = noise_sigma(cfg)
        assert abs(float(ratio.mean()) - 1.0) < 5 * sigma / 707
        assert abs(float(ratio.std()) - sigma) < 5 * sigma / 1000
        ref = np.asarray(ref_device.apply_write_noise(
            jax.random.PRNGKey(1), jnp.asarray(w.numpy()), _ref_dev(cfg)))
        ref_ratio = ref / w.numpy()
        assert abs(ref_ratio.std() - sigma) < 5 * sigma / 1000

    def test_write_noise_is_the_generator_draw(self):
        """Same seed, same noise; the steps round as the reference's
        ``(normal * sigma)``, ``1 + eta``, ``weights * (...)`` do."""
        w = torch.from_numpy(_levels(np.random.default_rng(2), (7, 33)))
        cfg = DeviceConfig("tite2", 3, 2)
        a = apply_write_noise(_gen(5), w, cfg)
        eta = torch.randn(w.shape, generator=_gen(5)) * np.float32(
            noise_sigma(cfg))
        torch.testing.assert_close(a, w.float() * (1.0 + eta), rtol=0,
                                   atol=0)


# --------------------------------------------------------------------------
# array (TestArray)
# --------------------------------------------------------------------------

class TestArray:
    def test_dac_clamps(self):
        x = np.asarray([-10.0, -1.2, 0.4, 9.0, 2.5, -0.5, 1.5],
                       dtype=np.float32)
        out = dac_quantize(torch.from_numpy(x), ArrayConfig())
        np.testing.assert_array_equal(out.numpy()[:4], [-3, -1, 0, 3])
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            ref_array.dac_quantize(jnp.asarray(x), ref_array.ArrayConfig())))

    def test_adc_saturates_and_quantizes(self):
        cfg = ArrayConfig(adc_bits=6)
        fs = 10.0
        lsb = fs / cfg.adc_levels
        x = np.asarray([0.0, lsb * 0.4, lsb * 0.6, 100.0, -100.0],
                       dtype=np.float32)
        out = adc_quantize(torch.from_numpy(x), cfg, fs).numpy()
        assert out[0] == 0
        assert out[1] == 0 and out[2] == pytest.approx(lsb)
        assert out[3] == pytest.approx(fs) and out[4] == pytest.approx(-fs)

    @pytest.mark.parametrize("adc_bits,fs", [(6, 10.0), (4, 135.7645),
                                             (8, 3.0)])
    def test_adc_equals_the_reference(self, adc_bits, fs):
        rng = np.random.default_rng(adc_bits)
        x = (rng.standard_normal(4000) * 2 * fs).astype(np.float32)
        cfg = ArrayConfig(adc_bits=adc_bits)
        np.testing.assert_array_equal(
            adc_quantize(torch.from_numpy(x), cfg, fs).numpy(),
            np.asarray(ref_array.adc_quantize(jnp.asarray(x), _ref_arr(cfg),
                                              fs)))

    @pytest.mark.parametrize("cfg", [ArrayConfig(), ArrayConfig(cols=64),
                                     ArrayConfig(bits_per_cell=1),
                                     ArrayConfig(full_scale=77.0)])
    def test_default_full_scale_equals_the_reference(self, cfg):
        assert default_full_scale(cfg) == ref_array.default_full_scale(
            _ref_arr(cfg))

    def test_ideal_limit_matches_exact_dot(self):
        rng = np.random.default_rng(0)
        q = rng.integers(-3, 4, (4, 256)).astype(np.float32)
        w = rng.integers(-3, 4, (8, 256)).astype(np.float32)
        cfg = ArrayConfig(adc_bits=24, full_scale=4096.0)
        out = imc_mvm_reference(torch.from_numpy(q), torch.from_numpy(w), cfg)
        np.testing.assert_allclose(out.numpy(), q @ w.T, rtol=1e-4, atol=0.2)

    def test_quantization_error_bounded(self):
        rng = np.random.default_rng(1)
        q = rng.integers(-3, 4, (8, 384)).astype(np.float32)
        w = rng.integers(-3, 4, (16, 384)).astype(np.float32)
        cfg = ArrayConfig(adc_bits=6)
        out = imc_mvm_reference(torch.from_numpy(q), torch.from_numpy(w),
                                cfg).numpy()
        lsb = default_full_scale(cfg) / cfg.adc_levels
        assert np.abs(out - q @ w.T).max() <= 3 * lsb / 2 + 1e-3

    def test_program_then_mvm(self):
        hv = torch.from_numpy(_levels(np.random.default_rng(2), (16, 128)))
        state = program_hvs(_gen(0), hv, ArrayConfig(),
                            DeviceConfig("tite2", 3, 5))
        scores = imc_mvm(hv.float(), state)
        assert (scores.numpy().argmax(1) == np.arange(16)).mean() > 0.9

    @pytest.mark.parametrize("Q,R,Dp,cfg", [
        (4, 16, 128, ArrayConfig()),
        (9, 70, 300, ArrayConfig()),
        (5, 33, 683, ArrayConfig(adc_bits=4)),
        (3, 20, 342, ArrayConfig(cols=64, dac_bits=2)),
        (6, 12, 200, ArrayConfig(bits_per_cell=2, full_scale=60.0)),
    ])
    def test_mvm_on_the_reference_bank(self, Q, R, Dp, cfg):
        """The reference's programmed bank crosses through ``convert``;
        ``imc_mvm`` and ``imc_mvm_reference`` equal each other bit for bit
        and the reference within rtol 1e-5 / atol 1e-3."""
        rng = np.random.default_rng(Q * R + Dp)
        hv = _levels(rng, (R, Dp), cfg.bits_per_cell)
        q = _levels(rng, (Q, Dp), cfg.bits_per_cell)
        dev = DeviceConfig("tite2", cfg.bits_per_cell, 3)
        ref_state = ref_array.program_hvs(jax.random.PRNGKey(Q), jnp.asarray(
            hv), _ref_arr(cfg), _ref_dev(dev))
        want = np.asarray(ref_array.imc_mvm(jnp.asarray(q, jnp.float32),
                                            ref_state))
        state = imc_state_from_numpy(np.asarray(ref_state.weights),
                                     ref_state.cfg, ref_state.device, CPU)
        assert state.cfg == cfg and state.device == dev
        got = imc_mvm(torch.from_numpy(q), state)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        bare = imc_mvm_reference(torch.from_numpy(q), state.weights, cfg)
        assert torch.equal(got, bare)

    def test_integer_weights_equal_the_plain_kernel(self):
        """Integer-valued weights make every partial exact: the array model
        is the kernel's plain version, bit for bit."""
        rng = np.random.default_rng(4)
        q = torch.from_numpy(_levels(rng, (7, 300)).astype(np.float32))
        w = torch.from_numpy(_levels(rng, (40, 300)).astype(np.float32))
        cfg = ArrayConfig()
        got = imc_mvm_reference(q, w, cfg)
        want = imc_mvm_plain(q, w, full_scale=default_full_scale(cfg))
        assert torch.equal(got, want)

    def test_adc_without_levels_raises_in_both(self):
        """adc_bits = 1 leaves no ADC level: the reference divides by zero,
        the port's kernel wrapper raises ValueError (ROADMAP Queue 3)."""
        cfg = ArrayConfig(adc_bits=1)
        q = np.ones((1, 4), np.float32)
        with pytest.raises(ZeroDivisionError):
            ref_array.imc_mvm_reference(jnp.asarray(q), jnp.asarray(q),
                                        _ref_arr(cfg))
        with pytest.raises(ValueError, match="adc_levels"):
            imc_mvm_reference(torch.from_numpy(q), torch.from_numpy(q), cfg)


# --------------------------------------------------------------------------
# ISA (TestISA)
# --------------------------------------------------------------------------

class TestISA:
    def test_roundtrip(self):
        inst = Instruction(Opcode.MVM_COMPUTE, arr_idx=37, col_addr=5,
                           row_addr=1023, mlc_bits=3, aux=6)
        assert decode_instruction(encode_instruction(inst)) == inst

    def test_encoding_is_64bit(self):
        inst = Instruction(Opcode.STORE_HV, arr_idx=2**16 - 1, col_addr=255,
                           row_addr=2**16 - 1, mlc_bits=15, aux=63)
        assert encode_instruction(inst) < 2**64

    @pytest.mark.parametrize("field,value", [("arr_idx", 2**16),
                                             ("aux", 64), ("col_addr", 256),
                                             ("row_addr", -1),
                                             ("mlc_bits", 16)])
    def test_field_validation(self, field, value):
        with pytest.raises(ValueError):
            Instruction(Opcode.READ_HV, **{field: value})
        with pytest.raises(ValueError):
            ref_isa.Instruction(ref_isa.Opcode.READ_HV, **{field: value})

    @settings(deadline=None, max_examples=60)
    @given(st.sampled_from([1, 2, 3]), st.integers(0, 2**16 - 1),
           st.integers(0, 255), st.integers(0, 2**16 - 1),
           st.integers(0, 15), st.integers(0, 63))
    def test_encoding_equals_the_reference(self, op, arr, col, row, mlc, aux):
        fields = dict(arr_idx=arr, col_addr=col, row_addr=row, mlc_bits=mlc,
                      aux=aux)
        word = encode_instruction(Instruction(Opcode(op), **fields))
        assert word == ref_isa.encode_instruction(
            ref_isa.Instruction(ref_isa.Opcode(op), **fields))
        got = decode_instruction(word)
        want = ref_isa.decode_instruction(word)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)

    def test_compile_db_search_equals_the_reference(self):
        got = compile_db_search(1000, 342, ArrayConfig(), 3, 6, 3)
        want = ref_isa.compile_db_search(1000, 342, ref_array.ArrayConfig(),
                                         3, 6, 3)
        assert [encode_instruction(i) for i in got] == \
            [ref_isa.encode_instruction(i) for i in want]

    def test_executor_store_mvm(self):
        refs = torch.from_numpy(_levels(np.random.default_rng(3), (32, 256)))
        ex = ISAExecutor(ArrayConfig(), DeviceConfig("tite2", 3, 3),
                         device=CPU)
        ex.load_stage(refs)
        ex.execute_one(Instruction(Opcode.STORE_HV, mlc_bits=3, aux=3))
        ex.load_stage(refs[:4])
        ex.execute_one(Instruction(Opcode.MVM_COMPUTE, mlc_bits=3, aux=6))
        assert ex.result.shape == (4, 32)
        assert (ex.result.numpy().argmax(1) == np.arange(4)).all()
        assert ex.trace.cycles > 0 and ex.trace.energy_j > 0
        assert ex.trace.instructions == 2

    def test_executor_read(self):
        refs = _levels(np.random.default_rng(4), (16, 128))
        ex = ISAExecutor(ArrayConfig(), DeviceConfig("tite2", 3, 5), seed=7,
                         device=CPU)
        ex.load_stage(refs)
        ex.execute_one(Instruction(Opcode.STORE_HV, mlc_bits=3, aux=5))
        ex.execute_one(Instruction(Opcode.READ_HV, row_addr=0, aux=8))
        assert ex.stage.shape == (8, 128) and ex.stage.dtype == torch.int8
        assert (ex.stage.numpy() == refs[:8]).mean() > 0.6

    def test_executor_seed_fixes_the_noise(self):
        refs = _levels(np.random.default_rng(5), (8, 64))
        states = []
        for seed in (3, 3, 4):
            ex = ISAExecutor(ArrayConfig(), DeviceConfig(), seed=seed,
                             device=CPU)
            ex.load_stage(refs)
            ex.execute_one(Instruction(Opcode.STORE_HV, aux=1))
            states.append(ex.state.weights)
        assert torch.equal(states[0], states[1])
        assert not torch.equal(states[0], states[2])

    @pytest.mark.parametrize("row_addr,aux", [(8, 4), (0, 4), (6, 4), (9, 1),
                                              (3, 0), (0, 10), (65535, 2)])
    def test_read_hv_equals_the_reference(self, row_addr, aux):
        """READ_HV on the reference's programmed 10-row bank: the same rows
        (``dynamic_slice_in_dim`` clamps the start: row_addr 8 with 4 rows
        reads rows 6-9), rounded half to even, and the same trace."""
        rng = np.random.default_rng(row_addr + 100 * aux)
        bank = _levels(rng, (10, 200))
        ref_ex = ref_isa.ISAExecutor(ref_array.ArrayConfig(),
                                     ref_device.DeviceConfig("tite2", 3, 0),
                                     seed=1)
        ref_ex.load_stage(jnp.asarray(bank))
        ref_ex.execute_one(ref_isa.Instruction(ref_isa.Opcode.STORE_HV,
                                               mlc_bits=3, aux=0))
        weights = np.asarray(ref_ex.state.weights).copy()
        weights[:, :4] = [[0.5, 1.5, 2.5, -0.5]]  # half to even in both
        ref_ex.state.weights = jnp.asarray(weights)
        ex = ISAExecutor(ArrayConfig(), DeviceConfig("tite2", 3, 0),
                         device=CPU)
        ex.load_stage(bank)
        ex.execute_one(Instruction(Opcode.STORE_HV, mlc_bits=3, aux=0))
        ex.state = imc_state_from_numpy(weights, ref_ex.state.cfg,
                                        ref_ex.state.device, CPU)
        ref_ex.execute_one(ref_isa.Instruction(ref_isa.Opcode.READ_HV,
                                               row_addr=row_addr, aux=aux))
        ex.execute_one(Instruction(Opcode.READ_HV, row_addr=row_addr,
                                   aux=aux))
        np.testing.assert_array_equal(ex.stage.numpy(),
                                      np.asarray(ref_ex.stage))
        assert ex.stage.dtype == torch.int8
        assert dataclasses.asdict(ex.trace) == dataclasses.asdict(
            ref_ex.trace)

    def test_read_hv_past_the_bank_raises_in_both(self):
        bank = _levels(np.random.default_rng(0), (4, 16))
        ref_ex = ref_isa.ISAExecutor(ref_array.ArrayConfig(),
                                     ref_device.DeviceConfig())
        ref_ex.load_stage(jnp.asarray(bank))
        ref_ex.execute_one(ref_isa.Instruction(ref_isa.Opcode.STORE_HV))
        ex = ISAExecutor(ArrayConfig(), DeviceConfig(), device=CPU)
        ex.load_stage(bank)
        ex.execute_one(Instruction(Opcode.STORE_HV))
        with pytest.raises(TypeError):
            ref_ex.execute_one(ref_isa.Instruction(ref_isa.Opcode.READ_HV,
                                                   aux=5))
        with pytest.raises(ValueError, match="READ_HV"):
            ex.execute_one(Instruction(Opcode.READ_HV, aux=5))

    @pytest.mark.parametrize("nrow,adc_bits,mlc,dp", [(0, 6, 3, 256),
                                                      (20, 4, 3, 300),
                                                      (7, 6, 2, 130)])
    def test_mvm_compute_equals_the_reference(self, nrow, adc_bits, mlc, dp):
        """STORE_HV then MVM_COMPUTE on the reference's programmed bank:
        the same trace exactly, the scores within rtol 1e-5 / atol 1e-3."""
        rng = np.random.default_rng(nrow + dp)
        bank = _levels(rng, (48, dp), mlc)
        q = _levels(rng, (5, dp), mlc)
        stream = [Instruction(Opcode.STORE_HV, mlc_bits=mlc, aux=2),
                  Instruction(Opcode.MVM_COMPUTE, row_addr=nrow,
                              mlc_bits=mlc, aux=adc_bits)]
        ref_ex = ref_isa.ISAExecutor(ref_array.ArrayConfig(),
                                     ref_device.DeviceConfig(), seed=2)
        ex = ISAExecutor(ArrayConfig(), DeviceConfig(), seed=2, device=CPU)
        ref_ex.load_stage(jnp.asarray(bank))
        ex.load_stage(bank)
        ref_ex.execute_one(ref_isa.decode_instruction(
            encode_instruction(stream[0])))
        ex.execute_one(stream[0])
        ex.state = imc_state_from_numpy(np.asarray(ref_ex.state.weights),
                                        ref_ex.state.cfg,
                                        ref_ex.state.device, CPU)
        ref_ex.load_stage(jnp.asarray(q))
        ex.load_stage(torch.from_numpy(q))
        ref_ex.execute_one(ref_isa.decode_instruction(
            encode_instruction(stream[1])))
        ex.execute_one(stream[1])
        np.testing.assert_allclose(ex.result.numpy(),
                                   np.asarray(ref_ex.result), rtol=RTOL,
                                   atol=ATOL)
        assert ex.result.shape == (5, nrow or 48)
        assert dataclasses.asdict(ex.trace) == dataclasses.asdict(
            ref_ex.trace)

    def test_mvm_compute_with_one_adc_bit_raises_in_both(self):
        bank = _levels(np.random.default_rng(1), (4, 16))
        ref_ex = ref_isa.ISAExecutor(ref_array.ArrayConfig(),
                                     ref_device.DeviceConfig())
        ex = ISAExecutor(ArrayConfig(), DeviceConfig(), device=CPU)
        ref_ex.load_stage(jnp.asarray(bank))
        ex.load_stage(bank)
        ref_ex.execute_one(ref_isa.Instruction(ref_isa.Opcode.STORE_HV))
        ex.execute_one(Instruction(Opcode.STORE_HV))
        for aux in (0, 1):
            with pytest.raises(ZeroDivisionError):
                ref_ex.execute_one(ref_isa.Instruction(
                    ref_isa.Opcode.MVM_COMPUTE, aux=aux))
            with pytest.raises(ValueError, match="adc_levels"):
                ex.execute_one(Instruction(Opcode.MVM_COMPUTE, aux=aux))

    def test_executor_errors(self):
        ex = ISAExecutor(ArrayConfig(), DeviceConfig(), device=CPU)
        with pytest.raises(RuntimeError, match="empty staging"):
            ex.execute_one(Instruction(Opcode.STORE_HV))
        with pytest.raises(RuntimeError, match="before STORE_HV"):
            ex.execute_one(Instruction(Opcode.READ_HV))
        ex.load_stage(np.ones((2, 8), np.int8))
        with pytest.raises(RuntimeError, match="programmed state"):
            ex.execute_one(Instruction(Opcode.MVM_COMPUTE, aux=6))


# --------------------------------------------------------------------------
# energy model (TestEnergyModel)
# --------------------------------------------------------------------------

class TestEnergyModel:
    @pytest.mark.parametrize("ds,col", [("PXD001468", "SpecPCM(paper)"),
                                        ("PXD000561", "SpecPCM(paper)")])
    def test_clustering_latency_within_10pct(self, ds, col):
        r = clustering_cost(DATASETS[ds]["num_spectra"])
        assert r.latency_s == pytest.approx(PAPER_TABLE2[ds][col], rel=0.10)

    @pytest.mark.parametrize("ds", ["iPRG2012", "HEK293"])
    def test_db_search_latency_within_10pct(self, ds):
        d = DATASETS[ds]
        r = db_search_cost(d["num_queries"], d["num_refs"],
                           candidate_fraction=d["candidate_fraction"])
        assert r.latency_s == pytest.approx(
            PAPER_TABLE3[ds]["SpecPCM(paper)"], rel=0.10)

    def test_db_search_energy(self):
        d = DATASETS["HEK293"]
        r = db_search_cost(d["num_queries"], d["num_refs"],
                           candidate_fraction=d["candidate_fraction"])
        assert r.energy_j == pytest.approx(PAPER_ENERGY["HEK293_db_search_j"],
                                           rel=0.10)

    def test_clustering_energy(self):
        r = clustering_cost(DATASETS["PXD000561"]["num_spectra"])
        assert r.energy_j == pytest.approx(
            PAPER_ENERGY["PXD000561_clustering_j"], rel=0.15)

    def test_adc_bits_scale_energy(self):
        e6 = DEFAULT_HW.macro_power_w(6) - DEFAULT_HW.macro_power_w(1)
        e4 = DEFAULT_HW.macro_power_w(4) - DEFAULT_HW.macro_power_w(1)
        assert e6 / e4 == pytest.approx(63 / 15, rel=0.3)

    def test_mlc_speedup_vs_slc(self):
        d = DATASETS["HEK293"]
        slc = db_search_cost(d["num_queries"], d["num_refs"], mlc_bits=1,
                             candidate_fraction=d["candidate_fraction"])
        mlc = db_search_cost(d["num_queries"], d["num_refs"], mlc_bits=3,
                             candidate_fraction=d["candidate_fraction"])
        assert slc.latency_s / mlc.latency_s == pytest.approx(3.0, rel=0.15)

    def test_write_verify_scales_clustering_latency(self):
        a = clustering_cost(100_000, write_verify=0)
        b = clustering_cost(100_000, write_verify=3)
        assert b.breakdown["program_s"] == pytest.approx(
            4 * a.breakdown["program_s"], rel=0.01)

    def test_tables_equal_the_reference(self):
        assert PAPER_TABLE2 == ref_energy.PAPER_TABLE2
        assert PAPER_TABLE3 == ref_energy.PAPER_TABLE3
        assert PAPER_ENERGY == ref_energy.PAPER_ENERGY
        assert DATASETS == ref_energy.DATASETS
        assert dataclasses.asdict(DEFAULT_HW) == dataclasses.asdict(
            ref_energy.DEFAULT_HW)

    @pytest.mark.parametrize("mlc,adc,wv,material", [
        (3, 6, 0, "sb2te3"), (1, 4, 3, "tite2"), (2, 5, 5, "sb2te3"),
        (3, 6, 3, "tite2")])
    def test_cost_reports_equal_the_reference(self, mlc, adc, wv, material):
        kw = dict(mlc_bits=mlc, adc_bits=adc, write_verify=wv,
                  material=material)
        for n, d in ((1, 96), (10_624, 2049), (1_100_000, 2048),
                     (21_100_000, 8193)):
            got = clustering_cost(n, hd_dim=d, **kw)
            want = ref_energy.clustering_cost(n, hd_dim=d, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for q, r, frac in ((48, 48, 0.7), (15_867, 1_162_392, 0.025),
                           (4096, 1_162_392, 1e-4), (1, 3, 0.33333334)):
            for prog in (False, True):
                got = db_search_cost(q, r, candidate_fraction=frac,
                                     include_programming=prog, **kw)
                want = ref_energy.db_search_cost(
                    q, r, candidate_fraction=frac, include_programming=prog,
                    **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.speedup_vs(1.0) == want.speedup_vs(1.0)

    def test_op_meters_equal_the_reference(self):
        hw, rhw = DEFAULT_HW, ref_energy.DEFAULT_HW
        dev = DeviceConfig("tite2", 3, 2)
        for args in ((1, 1, 1), (32, 581_196, 22), (7, 129, 3)):
            assert energy.mvm_cycles(hw, *args) == ref_energy.mvm_cycles(
                rhw, *args)
            assert energy.mvm_energy_j(hw, *args, 6) == \
                ref_energy.mvm_energy_j(rhw, *args, 6)
            assert energy.program_cycles(hw, *args) == \
                ref_energy.program_cycles(rhw, *args)
        for cells in (1, 128, 12_345_678):
            assert energy.program_energy_j(hw, dev, cells, 3) == \
                ref_energy.program_energy_j(rhw, _ref_dev(dev), cells, 3)
            assert energy.read_cycles(hw, cells) == ref_energy.read_cycles(
                rhw, cells)
            assert energy.read_energy_j(hw, cells) == \
                ref_energy.read_energy_j(rhw, cells)
        for bits in range(1, 9):
            assert hw.macro_power_w(bits) == rhw.macro_power_w(bits)
            assert hw.mvm_op_energy_j(bits) == rhw.mvm_op_energy_j(bits)
        assert energy.stripes(2731) == ref_energy.stripes(2731) == 22
