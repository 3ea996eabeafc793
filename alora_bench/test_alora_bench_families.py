"""The harness's model code behind the ``stack`` family draws, scores and
counts exactly as the harness did before it moved there: at the reduced
size with seed 7, on ``granite-rag-alora`` and the tests' zamba2 cell
(``reduced.with_ssm_cell``), the SHA-256 of every drawn leaf (the
parameters and each adapter's tree, with its invocation ids), the
reference's logits at fixed positions of one base and one adapted
sequence, and ``step_flops`` of a prefill-heavy, a decode-only and an
adapted step equal the values frozen from commit 8b83b39 (the
harness's ``weights.draw``, ``reference.Reference`` and
``yardstick.step_flops`` there), bit for bit."""
from __future__ import annotations

import hashlib

import pytest
import torch

from alora_bench import harness, reduced, spec
from alora_bench.reference import Seq

# every value below was read at commit 8b83b3969c96ce6b5373561f7327414333080cde

CALLS = {
    "prefill": {"T": 128, "R": 3, "ctx": 5000, "adapted": 0,
                "ssd_ops": 123456789},
    "decode": {"T": 16, "R": 16, "ctx": 1600, "adapted": 0,
               "ssd_ops": 2345678},
    "adapted": {"T": 96, "R": 5, "ctx": 3000, "adapted": 40,
                "ssd_ops": 34567890}}
POSITIONS = [0, 1, 30, 54, 55, 56, 89]     # of a 90-token sequence
INV = 55                                   # where the adapter activates

DIMS = {
    "granite-rag-alora": {
        "activation": "swiglu",
        "d_ff": 512,
        "d_model": 256,
        "dtype": "float32",
        "head_dim": 32,
        "kinds": ["attn", "attn"],
        "norm_eps": 1e-05,
        "num_heads": 8,
        "num_kv_heads": 2,
        "num_layers": 2,
        "padded_vocab": 512,
        "rope_theta": 10000.0,
        "tie_embeddings": True,
        "vocab_size": 512,
    },
    "zamba2-rag-alora": {
        "activation": "swiglu",
        "conv_ch": 288,
        "d_ff": 256,
        "d_inner": 256,
        "d_model": 128,
        "dtype": "float32",
        "head_dim": 32,
        "kinds": ["ssm", "ssm", "attn", "ssm"],
        "norm_eps": 1e-05,
        "num_heads": 4,
        "num_kv_heads": 4,
        "num_layers": 4,
        "padded_vocab": 512,
        "rope_theta": 10000.0,
        "ssm": {"conv_width": 4, "expand": 2, "head_dim": 32, "ngroups": 1, "state_dim": 16},
        "ssm_heads": 8,
        "tie_embeddings": False,
        "vocab_size": 512,
    },
}

DRAWS = {      # leaf -> SHA-256 of its bytes; an adapter's invocation ids
    "granite-rag-alora": """
params.embed.tok dce08c0499dcb9ed818e04d968d4fdb3580e43f2ec2503cbac01daa37c903c7a
params.final_norm 893a106828fbdb9521e1d868c985aab7ad2ae2f606edc55329265a5e7676006c
params.layers.0.attn.wk a6c4d15e8d6d029798309dbb2789a10b5f47ba32baf25cd9b6bb3b824b15655a
params.layers.0.attn.wo ff04d2b64c66bf8f81f00abea00d7a37791a15df8b8ec55d530908f2720db2fd
params.layers.0.attn.wq 5b7ed99093ac3d116f0a0f5cace7c4c7d94703a914966cc1375420d9a12e6063
params.layers.0.attn.wv 8aa6e8d107a98519aadcb0db42205b024d3c346a1fff1a9234c310a5fb5a9b06
params.layers.0.ln1 893a106828fbdb9521e1d868c985aab7ad2ae2f606edc55329265a5e7676006c
params.layers.0.ln2 893a106828fbdb9521e1d868c985aab7ad2ae2f606edc55329265a5e7676006c
params.layers.0.mlp.w_down b2b17b7d96e99d17ec57c3c040f2b8ca0eef79d4d496693f83f17c83a03b97fd
params.layers.0.mlp.w_gate bb136ae618616917015e29ba41d94750797b98faffcd0f324530070b34459163
params.layers.0.mlp.w_up ced77dec1fc820e1b9583aad25645885beca4f73b6488d59f423570a0224b5c9
params.layers.1.attn.wk a3b9a45ca6e50848534d82a2c468debb2b06dcc4109ee51929188619ec870280
params.layers.1.attn.wo 36075bcc3b0c229a801f5a3959c12d59ab0bc5e2ec06ab5f844425d636875b44
params.layers.1.attn.wq 682497d9b4c01739f82f0482f0c31f3e938b5dedfb7b6a4567011e4aa37afd01
params.layers.1.attn.wv c588abc77211f8a925b539c3342106d6f26857e9aed091392236ad942078f6b9
params.layers.1.ln1 893a106828fbdb9521e1d868c985aab7ad2ae2f606edc55329265a5e7676006c
params.layers.1.ln2 893a106828fbdb9521e1d868c985aab7ad2ae2f606edc55329265a5e7676006c
params.layers.1.mlp.w_down d13988f5a90b9317643616c0a97e50df396fff4245966be56b9af05a5ec5fd7e
params.layers.1.mlp.w_gate 2e986773a314660d739cf26866e64032dc0ff5134b60e352e684938e4d7a09a8
params.layers.1.mlp.w_up 29f89907c0c576b9daf898ecae0fcc1afcd993ddd7a0098d51aa888f0943969d
alora0.ids 511,510,509
alora0.seg0.ak a7448e7b32faf27f54070f210e43dadbc6701585bc1d905a9be98f06d347f274
alora0.seg0.aq 51661c88733c24e6935194e81b87bf8d32b83496242f907f54e90c957d3cab1a
alora0.seg0.av 47c1bc3c3a90c6d0055d5e7ad2ade909a75350ae722010e451e7d9f6f1773430
alora0.seg0.bk 35f5001afc0fe08230b979c2542429e1db8505bb77099e4524a2547807efccdc
alora0.seg0.bq 87b2055ff7c2c5b17479006a4aba0201ebbee4597ca2654f70a4c73d0276ef33
alora0.seg0.bv 818a515b586e7c6b98ee294c6cf58210727e6f4f01ece5d140b08b9cf0e78a9e
alora1.ids 508,507,506
alora1.seg0.ak 141d0b04bd8777cf0f1416f61ac8c293d7e96bfe7060da78e2fd42bbe926aef2
alora1.seg0.aq 5ab54312b739c1430e2afa72c0a1257f4d6129294b716236244f13c17d3a1ef8
alora1.seg0.av 8f0e8fc40224cae9958131699e5b72034e42640cd6836c15e54eeb44638e40b5
alora1.seg0.bk 907f106d1232c4c4e116f5d4d37eb2c6c7a0a12ecd3b4875cc38312a352dee63
alora1.seg0.bq ed8526eb0b1c47a3179274aafda24039a7bed3132553f438ee112129712efc1d
alora1.seg0.bv 0fb261a88c39efc45558a747e45dd6f874b8cc799572536aaafa96f879461792
""",
    "zamba2-rag-alora": """
params.embed.tok 68e0f2c428c76ef43215953bbe1b1a33b5d9db89772e1a08d243acbce060cff1
params.embed.unembed 3aa502981629515b77bc30a3170e33c770e7bf378a3bc2ba0386e7dbd5d555fd
params.final_norm 02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac
params.layers.0.ln 02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac
params.layers.0.ssm.A_log ffcf71a94bf6fd6d9c4d4894c108a4754a167a4070c520818bc5dfcdbf5a496a
params.layers.0.ssm.D 4f05df05f8da9356bd66425351f166a5f7305b7c805e6900d9ec0f50790c9886
params.layers.0.ssm.conv_b 4cf9816ed1062189ff0c8d427fba5e912cc68fc9af76cf7f08fd255977de3b33
params.layers.0.ssm.conv_w 521cde533073e7492efae576353c1a588b11860724a8f79c426c3ed19adedd26
params.layers.0.ssm.dt_bias 8ef2bc2ad482bbe670ef323a3598fdb43f6804110dc9b3741b986b9b77b26866
params.layers.0.ssm.in_dt fe16683d0fb964fce2d51c32ea6328bf635b0f13d469b72d117c6ddc7bd0cf5d
params.layers.0.ssm.in_xbc c6a2b2de58c3dd13d049ce48723d0e16304aeb1cc7dfdc3edd75a2a428af165d
params.layers.0.ssm.in_z 037a26de12ae0fb85ac9409e2e24185aee2e5604e8869d0bf4f7ca0ed9e3687e
params.layers.0.ssm.norm_w 893a106828fbdb9521e1d868c985aab7ad2ae2f606edc55329265a5e7676006c
params.layers.0.ssm.out_proj de783724b8a01164e66ca4cfc26f466a33ba4027b56b24d985acf9cf71c7d438
params.layers.1.ln 02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac
params.layers.1.ssm.A_log ffcf71a94bf6fd6d9c4d4894c108a4754a167a4070c520818bc5dfcdbf5a496a
params.layers.1.ssm.D 4f05df05f8da9356bd66425351f166a5f7305b7c805e6900d9ec0f50790c9886
params.layers.1.ssm.conv_b 4cf9816ed1062189ff0c8d427fba5e912cc68fc9af76cf7f08fd255977de3b33
params.layers.1.ssm.conv_w 1a8925fb223e98266633b1cf49f0d7e1d95dc6decadd7b847f135b6cc8d3a093
params.layers.1.ssm.dt_bias 373984fa2879181d798c98b3dc52da09b4f4b7d9b427560ff67c45b85f7fcb2d
params.layers.1.ssm.in_dt e84d842f0dd32274f59db8cc53f6a5afcb6886f1af8d6051cf24e7693339c65b
params.layers.1.ssm.in_xbc 3a629770ed861f1b94c95bb88b8017eb043bc66c60ae92e76de76e6c30b04e24
params.layers.1.ssm.in_z 91857e4cca787344844845eb56accbc7c8fe683e13b87499166fad21b08ca79f
params.layers.1.ssm.norm_w 893a106828fbdb9521e1d868c985aab7ad2ae2f606edc55329265a5e7676006c
params.layers.1.ssm.out_proj c61c9ffc396d6e3fe6eb18b57c774f38ec27c558e273cd23d1429f05ae6f3120
params.layers.2.attn.wk ca4a8059fdb8dadd0800ee391017a71c8affcd7db8470796b1714169e0461ea7
params.layers.2.attn.wo 49071dbeddc70272e3af22222cc74e37ba2832d517b9c03c4fbb6be54dce9c94
params.layers.2.attn.wq e2909a6829840a4efcbe02f6f2a0a58aa04f0ecf85a610c7c5776782826b61cb
params.layers.2.attn.wv b33021b7c6fd332f74dfde3754149e191d9e9abc5a61836ee026ee04b4cdcf59
params.layers.2.ln1 02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac
params.layers.2.ln2 02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac
params.layers.2.mlp.w_down dcec654a39c5da12644ffff9bf3b6c9b9fa182fa83945346c9be397847a6a679
params.layers.2.mlp.w_gate d471519e897a5fd2b54f9e1c4295365fa7b981339a71b530ec28678e707d3dfd
params.layers.2.mlp.w_up c7913646caf0acf96365ac6082f15d33d04c043f18e4484d2e41065298066c70
params.layers.3.ln 02722f124d0f1736a9dd7c4ddcd05630dcf16ee1ce3454e9a876005ce005d4ac
params.layers.3.ssm.A_log ffcf71a94bf6fd6d9c4d4894c108a4754a167a4070c520818bc5dfcdbf5a496a
params.layers.3.ssm.D 4f05df05f8da9356bd66425351f166a5f7305b7c805e6900d9ec0f50790c9886
params.layers.3.ssm.conv_b 4cf9816ed1062189ff0c8d427fba5e912cc68fc9af76cf7f08fd255977de3b33
params.layers.3.ssm.conv_w e3c81b3736a4050a98f7507d9aaa053b2a7a8ba03cbaebcc00f95e8407f919dd
params.layers.3.ssm.dt_bias 1d5e32bc252c57b042fde809264de305d22b6730546caf2c1c1e13a5913f3327
params.layers.3.ssm.in_dt 43ad59b389a350d30774d745710a7e00b2030ed02087c8bb91c5b962eb8fa2e0
params.layers.3.ssm.in_xbc 7664f4f562389e920c451741e0c51dc171ae352a43e0e80ded5dbddb426b07e5
params.layers.3.ssm.in_z 1311ecfda9c1caf05702c1d4876468c55e81997a24c24c3bd1291cf9d5b8a9e0
params.layers.3.ssm.norm_w 893a106828fbdb9521e1d868c985aab7ad2ae2f606edc55329265a5e7676006c
params.layers.3.ssm.out_proj d4e63b3a73980aa5d504cc009fa8d882a256388d67b7e6b6c6de17102602f504
alora0.ids 511,510,509
alora0.seg0.a 2a815ad9181354f927bbd9382859b2a63ef8001290cb74bb5fbad6bc178aae50
alora0.seg0.b 4ac65f80a35d7e1a866c85af9170f8423b61ae48ea0999f29cf2ee948e61eb6f
alora0.seg1.ak 53f8b232576aa212e53835c16c494eb16c2a26aa16a36853a093a23a7095273e
alora0.seg1.aq 6df71cb181e9397da4913e2b69044aba0cd85f82bf15b6a7a410aad2fd9a015e
alora0.seg1.av bbfcd6438fc68252f0183a2109f07c233039788ceb3eef2d3b534bf998b1d6a4
alora0.seg1.bk 425e8ee8bd2a6279ac18335cbe8052e8891d0f98e816fa9d8b683b328192d260
alora0.seg1.bq 32b328fedcafc3ec8b0f3c51a3dd3171fe2bff7fed6b87a855a6bf32ffd8e85a
alora0.seg1.bv 01ddd1fef631c3a4a5551f83e88e583d29c7e8559f25e77eab4decb85541af3c
alora0.seg2.a 8ada168d466c540bfbf95297c55abc1e7dde5b05da9edeba3073257e056d2aa6
alora0.seg2.b 7521633740cf7b4f5d8c4c20746b76505d987ffe45f3d11144d50c233c6647fd
alora1.ids 508,507,506
alora1.seg0.a 538a3a09d2e87ff1d3aa89057f6f74768602fdb90ea7c57155e31087eeb4e230
alora1.seg0.b 068d509bbb93ef0bc0ee66b12ac9462a7bb9244c5396674b566995ee2f8ba964
alora1.seg1.ak 3ba7bcb3a856fa8e9107fbea9ded41cec4ba325c2ed9c852ddb3c7b466548afa
alora1.seg1.aq 8ab3471e6266c6aec0ff4f27555586bc439695d5753532193a1ba16ab4d7a477
alora1.seg1.av b30d252bd60a6ba677b2e93a87a588ee7ad020b68490466ed435735c8d2559f5
alora1.seg1.bk 65200003a1ea13fe3c4e3b5362dd86d974de75aab22fe7019be99cff04a58c4e
alora1.seg1.bq ebfd4bcec24004241095f654b22438d3c3c23cec0a51ce2395ae919e58aedf3d
alora1.seg1.bv 795782e4b642e64d6873485035c89dcbb503efe99bdaef66d3810603ba0c2b28
alora1.seg2.a 72c5912eb530608d4a5ecf93b419ea27ee04b5ff3cc026d9a8ed7f636319a09a
alora1.seg2.b 1bfb3112c06d626052604e6f5d1239c9a279ac043c6245e8f1b0a78787ed74b8
""",
}

LOGITS = {
    "granite-rag-alora": {
        "adapted": "d518e828e4f3c44c0f89f4e2d12aa3d11f4138ae8e28f41791af9a37b9d5499b",
        "base": "490de535ee726ed431f766355b45c0fd5a1205be1a58b92fef21f7b44543fe1e",
    },
    "zamba2-rag-alora": {
        "adapted": "d3796d11fe9e7fd0c62fafbfb9bd81da3e3e27f9ad11aaab36023a2380d69c4a",
        "base": "b6739187a023b414d30ae451c91685b703d1833a2960b8823bfe646290fa00f0",
    },
}

STEP_FLOPS = {
    "granite-rag-alora": {
        "adapted": 222838784,
        "decode": 43122688,
        "prefill": 296239104,
    },
    "zamba2-rag-alora": {
        "adapted": 199385206,
        "decode": 25235562,
        "prefill": 495580991,
    },
}


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def leaves(tree, prefix=""):
    """{"dotted.path": SHA-256} of every tensor of a nested tree."""
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in leaves(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, x in enumerate(tree)
                for k2, v in leaves(x, f"{prefix}{i}.").items()}
    return {prefix[:-1]: sha(tree)}


@pytest.fixture(scope="module")
def ssm_root(tmp_path_factory):
    return reduced.with_ssm_cell(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def prepared(ssm_root):
    out = {}
    for cell in DIMS:
        root = ssm_root if cell == reduced.SSM_CELL else spec.ROOT
        out[cell] = harness.prepare(cell, 7, "cpu", root=root,
                                    overrides=reduced.OVERRIDES, reduced=True)
    return out


@pytest.mark.parametrize("cell", sorted(DIMS))
def test_a_configuration_without_family_is_a_stack(cell, prepared):
    sp, _, dims, _ = prepared[cell]
    assert "family" not in sp.config
    assert sp.family.__file__ == str(sp.bench / "families" / "stack.py")
    assert dims == DIMS[cell]


@pytest.mark.parametrize("cell", sorted(DIMS))
def test_the_draws_are_the_parents(cell, prepared):
    _, _, _, w = prepared[cell]
    drawn = {f"params.{k}": v for k, v in leaves(w["params"]).items()}
    for name, ids, tree in w["adapters"]:
        drawn[f"{name}.ids"] = ",".join(map(str, ids))
        drawn.update(leaves(tree, f"{name}."))
    frozen = dict(line.split() for line in DRAWS[cell].strip().splitlines())
    assert drawn == frozen


@pytest.mark.parametrize("cell", sorted(DIMS))
def test_the_references_logits_are_the_parents(cell, prepared):
    sp, _, dims, w = prepared[cell]
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, dims["vocab_size"] - 8, (90,),
                           generator=g).tolist()
    ref = sp.family.reference(dims, w["params"], w["layers"], "cpu")
    base, adapted = ref.logits([Seq(tokens, None, 90, POSITIONS),
                                Seq(tokens, 1, INV, POSITIONS)])
    assert {"base": sha(base), "adapted": sha(adapted)} == LOGITS[cell]


@pytest.mark.parametrize("cell", sorted(DIMS))
def test_step_flops_are_the_parents(cell, prepared):
    sp, _, dims, _ = prepared[cell]
    rank = sp.config["adapters"]["rank"]
    assert {k: sp.family.step_flops(c, dims, rank)
            for k, c in CALLS.items()} == STEP_FLOPS[cell]
