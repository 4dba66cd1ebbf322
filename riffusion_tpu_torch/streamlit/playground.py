"""
Streamlit playground app router, the counterpart of
riffusion_tpu/streamlit/playground.py: the same eight pages.

Run: streamlit run riffusion_tpu_torch/streamlit/playground.py
or:  python -m riffusion_tpu_torch.streamlit.playground
"""

import importlib


PAGES = {
    "🏠 Home": "riffusion_tpu_torch.streamlit.tasks.home",
    "🌊 Text to Audio": "riffusion_tpu_torch.streamlit.tasks.text_to_audio",
    "✨ Audio to Audio": "riffusion_tpu_torch.streamlit.tasks.audio_to_audio",
    "🎭 Interpolation": "riffusion_tpu_torch.streamlit.tasks.interpolation",
    "✂️ Audio Splitter": "riffusion_tpu_torch.streamlit.tasks.split_audio",
    "📜 Text to Audio Batch": "riffusion_tpu_torch.streamlit.tasks.text_to_audio_batch",
    "📎 Sample Clips": "riffusion_tpu_torch.streamlit.tasks.sample_clips",
    "⏈ Image to Audio": "riffusion_tpu_torch.streamlit.tasks.image_to_audio",
}


def render() -> None:
    import streamlit as st

    st.set_page_config(layout="wide", page_icon="🎸")

    page = st.sidebar.selectbox("Page", list(PAGES.keys()))
    assert page is not None
    module = importlib.import_module(PAGES[page])
    module.render()


if __name__ == "__main__":
    try:
        import sys

        import streamlit.runtime
        import streamlit.web.cli as stcli
    except ImportError as e:
        raise SystemExit(
            "The playground requires streamlit (pip install streamlit). "
            f"Import failed: {e}"
        )
    if streamlit.runtime.exists():
        render()
    else:
        sys.argv = ["streamlit", "run", __file__]
        sys.exit(stcli.main())
